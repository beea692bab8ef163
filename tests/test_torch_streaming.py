"""The port's streaming stores (paper Section 3.2) and dense-score lowering
against the JAX reference.

Both packages get the same numpy data. The reference fits each model once;
``repro_torch.convert`` carries it across, so both encode with the same
weights. Checks:

(a) moments: ``init_from_artifacts``, ``insert``, ``remove`` and
    ``observe_queries`` within 1e-4 of the largest entry;
(b) refit: ``refresh`` by the sign-free score map A^T B (per cluster for
    GleanVec) within 1e-3 of its largest entry (fp32 eigensolvers); the
    Eq. 12 ``transition_matrix``, ``reproject`` and
    ``transition_condition`` on the reference's refreshed state carried
    across;
(c) store structure of ``build_streaming_artifacts`` for the six DR modes;
(d) ``insert_rows`` / ``remove_rows``: the same codes, ``live`` and, for
    the sorted layouts, exactly the same slots, with a re-insert of live
    ids;
(e) ``refresh_artifacts`` (``stored`` and ``full``) on the reference's
    churned store and refreshed state carried across;
(f) flat search on a churned store against the reference's served scan
    (``bruteforce.scan_scorer``), ID and OOD queries, never a dead id;
(g) ``scorer_scores`` against the reference's (Pallas in interpret mode)
    with dead columns, all six classes;
(h) the IVF streaming members give exactly the reference's lists;
(i) stream cycles swap through the port's ``ServingEngine``; a remove on
    a store without a live mask is refused by ``swap``;
and the churned aligned IVF of ``tests/test_ivf_scan.py::
test_fused_after_streaming_cycles`` (ROADMAP C1).

Tolerances: fp32 products summed in another order (``testing.dot_tol``);
int8 codes may differ by one level only at a rounding boundary (the
unrounded value within ``_BOUNDARY`` of k + 1/2, computed in float64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gleanvec as rgv
from repro.core import leanvec_sphering as rlvs
from repro.core import search as rsearch
from repro.core import streaming as rst
from repro.data import vectors as rvectors
from repro.index import bruteforce as rbf
from repro.index import ivf as rivf
from repro.kernels import ivf_scan_topk_ref as r_ivf_scan_topk_ref
from repro.kernels import scorer_scores as r_scorer_scores
from repro_torch import convert
from repro_torch import kernels as K
from repro_torch.core import search, streaming
from repro_torch.core import scorer as sc
from repro_torch.index import ivf
from repro_torch.serve.engine import ServingEngine
from repro_torch.testing import assert_topk_close, dot_tol

N0, CAP, D, DR, C, BLOCK, SLACK = 1200, 1600, 32, 8, 4, 32, 8
MODES = ("sphering", "gleanvec", "sphering-int8", "gleanvec-int8",
         "gleanvec-sorted", "gleanvec-int8-sorted")
SORTED = ("gleanvec-sorted", "gleanvec-int8-sorted")
_BOUNDARY = 1e-4       # levels from k + 1/2 where two roundings may differ
_REINSERT = np.r_[np.arange(30, 40), np.arange(5, 15),
                  np.arange(N0 + 200, N0 + 240)].astype(np.int32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, rel):
    a, b = np.asarray(_np(a), np.float64), np.asarray(_np(b), np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


def _norm(a):
    a = np.asarray(_np(a), np.float64)
    return float(np.linalg.norm(a.reshape(-1, a.shape[-1]), axis=1).max())


class _World:
    """Data, Gaussian learning queries (well-conditioned K_Q), both
    reference models and their carried-across copies, and per-mode
    reference stores (fresh and churned)."""

    def __init__(self):
        self.ds = rvectors.make_dataset("stream", n=CAP, d=D, n_queries=64,
                                        ood=True, seed=11)
        self.ds_id = rvectors.make_dataset("stream", n=CAP, d=D,
                                           n_queries=64, ood=False, seed=11)
        self.x = self.ds.database
        self.qg = np.random.default_rng(11).standard_normal(
            (256, D)).astype(np.float32)
        qg, x0 = jnp.asarray(self.qg), jnp.asarray(self.x[:N0])
        self.ref_models = {
            "sphering": rlvs.fit(qg, x0, DR),
            "gleanvec": rgv.fit(jax.random.PRNGKey(0), qg, x0, c=C, d=DR,
                                kmeans_iters=4),
        }
        self._cache = {}

    @staticmethod
    def family(mode):
        return "sphering" if mode.startswith("sphering") else "gleanvec"

    def ref_model(self, mode):
        return self.ref_models[self.family(mode)]

    def port_model(self, mode, model=None):
        model = self.ref_model(mode) if model is None else model
        build = convert.sphering_model if self.family(mode) == "sphering" \
            else convert.gleanvec_model
        return build(convert.arrays_of(model), "cpu")

    def ref_fresh(self, mode):
        return rst.build_streaming_artifacts(
            mode, jnp.asarray(self.x[:N0]), self.ref_model(mode),
            capacity=CAP, sort_block=BLOCK, slack_blocks=SLACK)

    def port_fresh(self, mode):
        return streaming.build_streaming_artifacts(
            mode, self.x[:N0], self.port_model(mode), capacity=CAP,
            sort_block=BLOCK, slack_blocks=SLACK, device="cpu")

    def churn(self, mod, arts, to_ids):
        """The churn both packages run: insert 200 rows into free slots,
        remove ids 5..24, then insert 60 rows at ids that are live (30..39),
        freed (5..14) and free."""
        rows1 = self.x[N0:N0 + 200]
        rows2 = self.x[N0 + 200:N0 + 260]
        arts, ids1 = mod.insert_rows(arts, rows1 if mod is streaming
                                     else jnp.asarray(rows1))
        arts = mod.remove_rows(arts, to_ids(np.arange(5, 25, dtype=np.int32)))
        arts, _ = mod.insert_rows(arts, rows2 if mod is streaming
                                  else jnp.asarray(rows2),
                                  ids=to_ids(_REINSERT))
        return arts, ids1

    def ref_churned(self, mode):
        if mode not in self._cache:
            self._cache[mode] = self.churn(rst, self.ref_fresh(mode),
                                           jnp.asarray)[0]
        return self._cache[mode]


@pytest.fixture(scope="module")
def world():
    return _World()


def _port_artifacts(ref_art, mode, world):
    """The reference's store carried across (scorer incl. ``live``, the
    rerank store, the model)."""
    s = ref_art.scorer
    return search.SearchArtifacts(
        scorer=convert.scorer(type(s).__name__, convert.arrays_of(s), "cpu"),
        x_full=_t(ref_art.x_full), model=world.port_model(mode,
                                                          ref_art.model))


def _codes_close(got, want, unrounded, label):
    """int8 codes equal, or one level apart where the float64 unrounded
    value lies within ``_BOUNDARY`` of a rounding boundary."""
    got, want = _np(got).astype(np.int64), _np(want).astype(np.int64)
    diff = got != want
    if not diff.any():
        return
    u = np.asarray(unrounded, np.float64)[diff]
    frac = np.abs(u - np.floor(u) - 0.5)
    ok = (np.abs(got[diff] - want[diff]) == 1) & (frac <= _BOUNDARY)
    assert ok.all(), (f"{label}: {int((~ok).sum())} codes differ away from "
                      f"a rounding boundary (max {np.abs(got - want).max()} "
                      f"levels, min boundary gap {frac[~ok].min():.3g})")


def _unrounded(low, lo, delta):
    return (np.asarray(low, np.float64) - np.asarray(lo, np.float64)) \
        / np.asarray(delta, np.float64)


def _ref_low(s, model, x, ids):
    """float64 reduced vectors of full-D ``x`` rows (the reference's
    arithmetic), for the rounding-boundary rule."""
    x = np.asarray(x, np.float64)
    b = np.asarray(model.b, np.float64)
    if b.ndim == 2:
        return x @ b.T, None
    tags = np.asarray(rgv.assign_tags(model, jnp.asarray(x, jnp.float32)))
    return np.einsum("ndk,nk->nd", b[tags], x), tags


# ---------------------------------------------------------------------------
# (a), (b): moments and refit.
# ---------------------------------------------------------------------------


def _states(world, mode):
    """Reference and port streaming states through the same updates:
    bootstrap from the fresh store, insert 200 rows, remove 20, observe a
    batch of Gaussian queries."""
    ref = rst.init_from_artifacts(world.ref_fresh(mode),
                                  jnp.asarray(world.qg[:128]))
    port = streaming.init_from_artifacts(world.port_fresh(mode),
                                         world.qg[:128])
    ins, rem = world.x[N0:N0 + 200], world.x[100:120]
    ref = rst.observe_queries(rst.remove(rst.insert(ref, jnp.asarray(ins)),
                                         jnp.asarray(rem)),
                              jnp.asarray(world.qg[128:]))
    port = streaming.observe_queries(
        streaming.remove(streaming.insert(port, ins), rem), world.qg[128:])
    return ref, port


@pytest.mark.parametrize("mode", ["sphering", "gleanvec"])
def test_moments_match_reference(world, mode):
    ref, port = _states(world, mode)
    _close(port.k_q, ref.k_q, 1e-4)
    _close(port.k_x, ref.k_x, 1e-4)
    assert tuple(port.k_x.shape) == tuple(ref.k_x.shape)
    assert port.updates_since == int(ref.updates_since) == 220
    # a single (D,) row updates like a (1, D) batch
    one = streaming.insert(port, world.x[N0 + 300])
    _close(one.k_x, streaming.insert(port, world.x[N0 + 300:N0 + 301]).k_x,
           1e-6)


@pytest.mark.parametrize("mode", ["sphering", "gleanvec"])
def test_refresh_and_transition_match_reference(world, mode):
    ref, port = _states(world, mode)
    ref_r, port_r = rst.refresh(ref), streaming.refresh(port)
    assert port_r.updates_since == 0 and not streaming.needs_refresh(port_r)
    # refit: the sign-free score map A^T B per cluster, and W
    a, b = _np(port_r.model.a), _np(port_r.model.b)
    ra, rb = np.asarray(ref_r.model.a), np.asarray(ref_r.model.b)
    if a.ndim == 2:
        a, b, ra, rb = a[None], b[None], ra[None], rb[None]
    for c in range(a.shape[0]):
        _close(a[c].T @ b[c], ra[c].T @ rb[c], 1e-3)
    _close(port_r.model.w, ref_r.model.w, 1e-3)
    _close(port_r.prev_bw, ref.model.b, 1e-6)
    # Eq. 12 on the reference's refreshed state carried across
    carried = convert.streaming_state(ref_r, "cpu")
    t_ref = np.asarray(rst.transition_matrix(ref_r))
    t = streaming.transition_matrix(carried)
    _close(t, t_ref, 1e-3)
    np.testing.assert_allclose(streaming.transition_condition(carried),
                               rst.transition_condition(ref_r), rtol=1e-3)
    x_low = np.random.default_rng(1).standard_normal(
        (300, DR)).astype(np.float32)
    pending = np.random.default_rng(2).random(300) < 0.5
    tags = np.random.default_rng(3).integers(0, C, 300).astype(np.int32)
    kw = {} if t.ndim == 2 else {"tags": tags}
    want = rst.reproject(ref_r, jnp.asarray(x_low),
                         pending=jnp.asarray(pending),
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    got = streaming.reproject(carried, _t(x_low), pending=_t(pending),
                              **{k: _t(v) for k, v in kw.items()})
    _close(got, want, 1e-4)
    np.testing.assert_array_equal(_np(got)[~pending], x_low[~pending])
    if t.ndim == 3:
        with pytest.raises(ValueError, match="tags"):
            streaming.reproject(carried, _t(x_low))


# ---------------------------------------------------------------------------
# (c), (d): store structure and row updates.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_store_structure_matches_reference(world, mode):
    ref, port = world.ref_fresh(mode), world.port_fresh(mode)
    rs, ps = ref.scorer, port.scorer
    assert type(ps).__name__ == type(rs).__name__
    for f in rs._fields:
        a, b = getattr(rs, f), getattr(ps, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert tuple(b.shape) == tuple(a.shape), f
    assert tuple(port.x_full.shape) == tuple(ref.x_full.shape) == (CAP, D)
    np.testing.assert_array_equal(_np(streaming.live_mask(port)),
                                  rst.live_mask(ref))
    if mode in SORTED:
        np.testing.assert_array_equal(_np(ps.inv_perm), np.asarray(rs.inv_perm))
        np.testing.assert_array_equal(_np(ps.perm), np.asarray(rs.perm))
    else:
        np.testing.assert_array_equal(_np(ps.live), np.asarray(rs.live))
    np.testing.assert_array_equal(_np(streaming.free_ids(port, 5)),
                                  rst.free_ids(ref, 5))


def test_host_rerank_is_refused():
    """A host-rerank store serves, but is refused where it does not fit: a
    swap between the two tiers changes the state's structure, and a store
    that is not (n, D) is no rerank tier."""
    x = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    model = streaming.init(torch.eye(8), torch.eye(8), 4).model
    host = streaming.build_streaming_artifacts("sphering", x[:48], model,
                                               capacity=64, host_rerank=True,
                                               device="cpu")
    dev = streaming.build_streaming_artifacts("sphering", x[:48], model,
                                              capacity=64, device="cpu")
    assert search.host_tier(host) is not None and search.host_tier(dev) is None
    for have, offer in ((dev, host), (host, dev)):
        engine = ServingEngine(search.make_state(have), k=4, kappa=8,
                               batch_size=4, dim=8)
        with pytest.raises(ValueError, match="structure"):
            engine.swap(search.make_state(offer))
        assert engine.version == 0
    from repro_torch.core import rerank_tier
    with pytest.raises(ValueError, match="host rerank"):
        rerank_tier.HostStore(x[0])


@pytest.mark.parametrize("mode", MODES)
def test_row_updates_match_reference(world, mode):
    ref, ids_r = world.churn(rst, world.ref_fresh(mode), jnp.asarray)
    port, ids_p = world.churn(streaming, world.port_fresh(mode),
                              lambda a: torch.from_numpy(a))
    np.testing.assert_array_equal(_np(ids_p), np.asarray(ids_r))
    rs, ps = ref.scorer, port.scorer
    np.testing.assert_array_equal(_np(streaming.live_mask(port)),
                                  rst.live_mask(ref))
    np.testing.assert_array_equal(_np(port.x_full), np.asarray(ref.x_full))
    if mode in SORTED:                        # exactly the same slots
        np.testing.assert_array_equal(_np(ps.perm), np.asarray(rs.perm))
        np.testing.assert_array_equal(_np(ps.inv_perm),
                                      np.asarray(rs.inv_perm))
    else:
        np.testing.assert_array_equal(_np(ps.live), np.asarray(rs.live))
    if hasattr(rs, "tags"):
        np.testing.assert_array_equal(_np(ps.tags), np.asarray(rs.tags))
    model = world.ref_model(mode)
    if hasattr(rs, "x_low"):
        tol = dot_tol(_norm(model.b), _norm(world.x), D)
        np.testing.assert_allclose(_np(ps.x_low), np.asarray(rs.x_low),
                                   rtol=0, atol=tol)
        return
    # codes: the unrounded values of every stored row, from the stored
    # original rows (the sorted layouts through their permutation)
    np.testing.assert_allclose(_np(ps.lo), np.asarray(rs.lo), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(rs.lo)).max())
    src = np.asarray(rs.perm) if mode in SORTED else np.arange(CAP)
    low, tags = _ref_low(rs, model, np.asarray(ref.x_full)[np.maximum(src, 0)],
                         None)
    lo, delta = np.asarray(rs.lo), np.asarray(rs.delta)
    if tags is not None:
        lo, delta = lo[tags], delta[tags]
    keep = src >= 0 if mode in SORTED else np.ones(CAP, bool)
    u = _unrounded(low, lo, delta)
    _codes_close(_np(ps.codes)[keep], np.asarray(rs.codes)[keep],
                 u[keep], mode)


def test_sorted_slots_out_of_slack_raise(world):
    port = world.port_fresh("gleanvec-sorted")
    model = world.port_model("gleanvec-sorted")
    big = np.repeat(world.x[:1], (SLACK + 1) * BLOCK, axis=0)  # > free
    with pytest.raises(ValueError, match="no free slots"):
        port.scorer.insert_rows(torch.arange(N0, N0 + big.shape[0]),
                                _t(big), model)


# ---------------------------------------------------------------------------
# (e): re-encoding.
# ---------------------------------------------------------------------------


def _refreshed_ref_state(world, mode, ref_art):
    st = rst.init_from_artifacts(ref_art, jnp.asarray(world.qg))
    st = rst.observe_queries(st, jnp.asarray(world.ds.queries_test))
    return rst.refresh(st)


@pytest.mark.parametrize("source", ["stored", "full"])
@pytest.mark.parametrize("mode", MODES)
def test_refresh_artifacts_matches_reference(world, mode, source):
    ref_art = world.ref_churned(mode)
    ref_state = _refreshed_ref_state(world, mode, ref_art)
    want = rst.refresh_artifacts(ref_art, ref_state, source=source)
    got = streaming.refresh_artifacts(
        _port_artifacts(ref_art, mode, world),
        convert.streaming_state(ref_state, "cpu"), source=source)
    ws, gs = want.scorer, got.scorer
    for f in ws._fields:
        a, b = getattr(ws, f), getattr(gs, f)
        if a is None or f in ("x_low", "codes", "lo", "delta"):
            continue
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(a).max()),
                                   err_msg=f)
    if hasattr(ws, "x_low"):
        tol = dot_tol(_norm(ws.x_low), 1.0, D) * 10 \
            + dot_tol(_norm(ref_art.x_full), _norm(ref_state.model.b), D)
        np.testing.assert_allclose(_np(gs.x_low), np.asarray(ws.x_low),
                                   rtol=0, atol=tol)
        return
    scale = np.abs(np.asarray(ws.lo)).max()
    _close(gs.lo, ws.lo, 1e-5)
    _close(gs.delta, ws.delta, 1e-5)
    # unrounded values: the reference's own re-encoding in float64
    rs = ref_art.scorer
    row_tags = None
    if hasattr(rs, "block_tags"):
        row_tags = np.repeat(np.asarray(rs.block_tags), rs.layout_block)
    elif hasattr(rs, "tags"):
        row_tags = np.asarray(rs.tags)
    old_lo, old_delta = np.asarray(rs.lo, np.float64), \
        np.asarray(rs.delta, np.float64)
    if row_tags is not None:
        old_lo, old_delta = old_lo[row_tags], old_delta[row_tags]
    old_low = np.asarray(rs.codes, np.float64) * old_delta + old_lo
    b = np.asarray(ref_state.model.b, np.float64)
    if source == "stored":
        t = np.asarray(rst.transition_matrix(ref_state), np.float64)
        new_low = old_low @ t.T if t.ndim == 2 else \
            np.einsum("nij,nj->ni", t[row_tags], old_low)
    else:
        x_full = np.asarray(ref_art.x_full, np.float64)
        if hasattr(rs, "perm"):
            x_full = x_full[np.maximum(np.asarray(rs.perm), 0)]
        new_low = x_full @ b.T if b.ndim == 2 else \
            np.einsum("ndk,nk->nd", b[row_tags], x_full)
    lo, delta = np.asarray(ws.lo), np.asarray(ws.delta)
    if row_tags is not None:
        lo, delta = lo[row_tags], delta[row_tags]
    _codes_close(gs.codes, ws.codes, _unrounded(new_low, lo, delta),
                 f"{mode}/{source}")
    assert scale > 0


# ---------------------------------------------------------------------------
# (f), (g): churned search and the dense lowering.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ood", [False, True], ids=["id", "ood"])
@pytest.mark.parametrize("mode", MODES)
def test_churned_flat_search_matches_served_scan(world, mode, ood):
    ref_art = world.ref_churned(mode)
    port = _port_artifacts(ref_art, mode, world)
    queries = (world.ds if ood else world.ds_id).queries_test[:16]
    rs, ps = ref_art.scorer, port.scorer
    k = 40
    want = rbf.scan_scorer(rs, rs.prepare_queries(jnp.asarray(queries)), k,
                           getattr(rs, "layout_block", 256))
    state = search.make_state(port)
    qstate = state.index.prepare_queries(ps, _t(queries))
    got = state.index.candidates(qstate, ps, k)
    lo = 0.0
    qs = qstate
    if isinstance(qstate, tuple):
        qs, lo = qstate.q_scaled, float(qstate.q_lo.abs().max())
    rows = ps.x_low if hasattr(ps, "x_low") else ps.codes
    tol = dot_tol(_norm(qs), _norm(rows), DR, lo)
    assert_topk_close(got, want, tol, f"{mode}/{'ood' if ood else 'id'}")
    live = _np(streaming.live_mask(port))
    ids = _np(got[1])
    assert (ids >= 0).all() and live[ids].all()          # no dead id
    # Algorithm 1 end to end: dead ids never reach the rerank
    final = search.state_search(_t(queries), state, 10, k)
    assert live[_np(final)].all()


@pytest.mark.parametrize("mode", ["sphering", "sphering-int8"])
def test_dead_winners_translate_to_minus_one(world, mode):
    """Fewer live rows than k on a live-masked linear / int8 store: the
    dense top-k's NEG_INF winners come back as id -1."""
    port = _port_artifacts(world.ref_fresh(mode), mode, world)
    s = port.scorer
    live = torch.zeros(CAP, dtype=torch.bool)
    live[[3, 7, 11]] = True
    s = s._replace(live=live)
    vals, ids = K.scorer_topk(s, _t(world.ds.queries_test[:4]), 10)
    assert sorted(_np(ids[0, :3]).tolist()) == [3, 7, 11]
    assert (_np(ids[:, 3:]) == -1).all() and (_np(vals[:, 3:]) < -1e37).all()


@pytest.mark.parametrize("mode", MODES)
def test_scorer_scores_matches_reference(world, mode):
    ref_art = world.ref_churned(mode)
    port = _port_artifacts(ref_art, mode, world)
    queries = world.ds.queries_test[:4]
    want = np.asarray(r_scorer_scores(ref_art.scorer, jnp.asarray(queries),
                                      interpret=True))
    got = _np(K.scorer_scores(port.scorer, _t(queries)))
    dead = want < -1e37
    np.testing.assert_array_equal(got < -1e37, dead)
    assert dead.any()
    qstate = port.scorer.prepare_queries(_t(queries))
    lo, qs = 0.0, qstate
    if isinstance(qstate, tuple):
        qs, lo = qstate.q_scaled, float(qstate.q_lo.abs().max())
    rows = port.scorer.x_low if hasattr(port.scorer, "x_low") \
        else port.scorer.codes
    tol = dot_tol(_norm(qs), _norm(rows), DR, lo)
    np.testing.assert_allclose(got[~dead], want[~dead], rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# (h), (i): IVF updates and swaps.
# ---------------------------------------------------------------------------


def test_ivf_streaming_members_match_reference(world):
    mode = "gleanvec-int8-sorted"
    model = world.ref_model(mode)
    ref_art = world.ref_fresh(mode)
    ridx = rivf.with_reduced_centers(
        rivf.with_list_slack(rivf.build_aligned(model,
                                                jnp.asarray(world.x[:N0]),
                                                nprobe=2), 60),
        ref_art.scorer, model)
    pidx = convert.ivf_index(ridx, "cpu")
    p0 = ivf.with_list_slack(convert.ivf_index(
        rivf.build_aligned(model, jnp.asarray(world.x[:N0]), nprobe=2),
        "cpu"), 60)
    np.testing.assert_array_equal(_np(p0.lists), np.asarray(ridx.lists))
    rows, ids = world.x[N0:N0 + 150], np.arange(N0, N0 + 150,
                                                dtype=np.int32)
    ridx = rivf.insert_ids(ridx, jnp.asarray(rows), jnp.asarray(ids))
    pidx = ivf.insert_ids(pidx, _t(rows), _t(ids))
    np.testing.assert_array_equal(_np(pidx.lists), np.asarray(ridx.lists))
    rm = np.r_[np.arange(10, 30), np.arange(N0 + 5, N0 + 9)].astype(np.int32)
    ridx, pidx = rivf.remove_ids(ridx, rm), ivf.remove_ids(pidx, _t(rm))
    np.testing.assert_array_equal(_np(pidx.lists), np.asarray(ridx.lists))
    ridx = rivf.insert_ids(ridx, jnp.asarray(world.x[10:30]),
                           jnp.asarray(np.arange(10, 30, dtype=np.int32)))
    pidx = ivf.insert_ids(pidx, _t(world.x[10:30]),
                          _t(np.arange(10, 30, dtype=np.int32)))
    np.testing.assert_array_equal(_np(pidx.lists), np.asarray(ridx.lists))
    # refreshed: the center companion re-encoded under a refreshed model
    ref_state = _refreshed_ref_state(world, mode, ref_art)
    rart = rst.refresh_artifacts(ref_art, ref_state)
    part = streaming.refresh_artifacts(_port_artifacts(ref_art, mode, world),
                                       convert.streaming_state(ref_state,
                                                               "cpu"))
    rref = ridx.refreshed(rart.scorer, rart.model)
    pref = pidx.refreshed(part.scorer, part.model)
    assert type(pref.center_scorer).__name__ == \
        type(rref.center_scorer).__name__
    for f in ("codes", "tags", "lo", "delta"):
        _close(getattr(pref.center_scorer, f),
               getattr(rref.center_scorer, f), 1e-4)
    # full lists raise, as the reference
    with pytest.raises(ValueError, match="full"):
        ivf.insert_ids(convert.ivf_index(rivf.build_aligned(
            model, jnp.asarray(world.x[:N0]), nprobe=2), "cpu"),
            _t(rows), _t(ids))


@pytest.mark.parametrize("mode,index", [("gleanvec-int8-sorted", "ivf"),
                                        ("sphering-int8", "flat"),
                                        ("gleanvec", "flat")])
def test_stream_cycles_swap_without_signature_change(world, mode, index):
    """Three CLI stream cycles (insert + remove + refresh) through the
    port's ServingEngine: every swap passes its structure check, the
    version moves, and dead ids never come back."""
    from repro_torch.launch import serve
    model = world.port_model(mode)
    x = _t(world.x)
    slack = serve.stream_slack_blocks(model, x[N0:], BLOCK) \
        if mode in SORTED else 1
    state = serve.build_stream(mode, x, N0, CAP, model, index=index,
                               nprobe=2, reduced_probe=True,
                               slack_blocks=slack, list_slack=200,
                               device="cpu")
    engine = ServingEngine(state, k=10, kappa=20, batch_size=16, dim=D)
    stream = streaming.init_from_artifacts(state.artifacts, world.qg)
    queries = world.ds.queries_test
    for cycle in range(3):
        obs = queries[cycle * 16:(cycle + 1) * 16]
        served = engine.submit(obs)
        stream = streaming.observe_queries(stream, obs)
        rm = np.arange(cycle * 20, cycle * 20 + 10)
        stream, rep = serve.stream_cycle(
            engine, stream, x[N0 + cycle * 100:N0 + (cycle + 1) * 100],
            remove=rm)
        assert np.isfinite(rep["condition"])
        live = _np(streaming.live_mask(engine.state.artifacts))
        assert not live[rm].any()
        assert serve.live_recall(engine, obs, served) > 0.5
    assert engine.n_swaps == 6 and engine.version == 6
    assert live.sum() == N0 + 300 - 30
    ids = engine.submit(queries[:16])
    assert live[ids[ids >= 0]].all()


def test_remove_without_live_mask_is_refused_by_swap(world):
    """A store built without a live mask materialises one on its first
    remove: a structure change the engine refuses, as the reference's."""
    model = world.port_model("gleanvec")
    art = search.build_artifacts("gleanvec", world.x[:N0], model,
                                 device="cpu")
    engine = ServingEngine(search.make_state(art), k=10, kappa=20,
                           batch_size=16, dim=D)
    gone = streaming.remove_rows(art, np.arange(5))
    assert gone.scorer.live is not None and art.scorer.live is None
    with pytest.raises(ValueError, match="structure"):
        engine.swap(engine.state._replace(artifacts=gone))
    assert engine.version == 0


# ---------------------------------------------------------------------------
# ROADMAP C1: the churned aligned IVF of test_fused_after_streaming_cycles.
# ---------------------------------------------------------------------------


_C1 = dict(n0=1536, cap=2048, step=128, sort_block=64, slack_blocks=3)


@pytest.fixture(scope="module")
def c1_world():
    ds = rvectors.make_dataset("ivfscan", n=2048, d=64, n_queries=32,
                               ood=True, seed=9)
    x = jnp.asarray(ds.database)
    gvm = rgv.fit(jax.random.PRNGKey(0), jnp.asarray(ds.queries_learn), x,
                  c=8, d=24)
    return ds, x, gvm


def _c1_cycles(pkg_stream, pkg_ivf, arts, index, x, to_ids, cycles=3):
    """The reference test's cycles: insert STEP rows (free ids), remove
    ids cycle*20 .. +10, in the store and the lists."""
    n0, step = _C1["n0"], _C1["step"]
    for cycle in range(cycles):
        rows = x[n0 + cycle * step: n0 + (cycle + 1) * step]
        arts, new_ids = pkg_stream.insert_rows(arts, rows)
        index = pkg_ivf.insert_ids(index, rows, new_ids)
        rm = to_ids(np.arange(cycle * 20, cycle * 20 + 10, dtype=np.int32))
        arts = pkg_stream.remove_rows(arts, rm)
        index = pkg_ivf.remove_ids(index, rm)
    return arts, index


@pytest.mark.parametrize("mode", SORTED)
def test_c1_churned_aligned_ivf(c1_world, mode):
    """With the reference test's list slack (4 * STEP // C + 8 = 72) the
    lists overflow in its second cycle, in both packages alike -- the C1
    failure is this ValueError, before either of the test's checks. With
    slack for every insert, the port's fused and gathered fine steps agree
    on the reference's churned state, and each agrees with the reference's
    gathered step and its ``ivf_scan_topk_ref``."""
    ds, x, gvm = c1_world
    n0, cap = _C1["n0"], _C1["cap"]
    qt = np.asarray(ds.queries_test[:16])

    def ref_store():
        return rst.build_streaming_artifacts(
            mode, x[:n0], gvm, capacity=cap, sort_block=_C1["sort_block"],
            slack_blocks=_C1["slack_blocks"])

    small = 4 * _C1["step"] // gvm.n_clusters + 8
    ridx = rivf.with_list_slack(rivf.build_aligned(gvm, x[:n0], nprobe=3),
                                small)
    with pytest.raises(ValueError, match="posting list .* is full"):
        _c1_cycles(rst, rivf, ref_store(), ridx, x, jnp.asarray, cycles=2)
    port_model = convert.gleanvec_model(convert.arrays_of(gvm), "cpu")
    pidx = ivf.with_list_slack(convert.ivf_index(
        rivf.build_aligned(gvm, x[:n0], nprobe=3), "cpu"), small)
    parts = streaming.build_streaming_artifacts(
        mode, np.asarray(x[:n0]), port_model, capacity=cap,
        sort_block=_C1["sort_block"], slack_blocks=_C1["slack_blocks"],
        device="cpu")
    with pytest.raises(ValueError, match="posting list .* is full"):
        _c1_cycles(streaming, ivf, parts, pidx, _t(np.asarray(x)),
                   torch.from_numpy, cycles=2)

    # enough list slack for every insert: the reference's churned state
    wide = cap - n0
    ridx = rivf.with_reduced_centers(
        rivf.with_list_slack(rivf.build_aligned(gvm, x[:n0], nprobe=3),
                             wide), ref_store().scorer, gvm)
    rarts, ridx = _c1_cycles(rst, rivf, ref_store(), ridx, x, jnp.asarray)
    rs = rarts.scorer
    ps = convert.scorer(type(rs).__name__, convert.arrays_of(rs), "cpu")
    pidx = convert.ivf_index(ridx, "cpu")
    fused = pidx.search(_t(qt), ps, 10)
    gathered = ivf.search_scorer(_t(qt), ps, pidx.__class__(
        centers=pidx.centers, lists=pidx.lists,
        center_scorer=pidx.center_scorer, nprobe=3, aligned_layout=False),
        10, nprobe=3)
    qstate = ps.prepare_queries(_t(qt))
    lo, qs = 0.0, qstate
    if isinstance(qstate, tuple):
        qs, lo = qstate.q_scaled, float(qstate.q_lo.abs().max())
    rows = ps.x_low if hasattr(ps, "x_low") else ps.codes
    tol = dot_tol(_norm(qs), _norm(rows), 24, lo)
    assert_topk_close(fused, gathered, tol, "port fused vs port gathered")
    ref_gathered = rivf.IVFIndex(
        centers=ridx.centers, lists=ridx.lists,
        center_scorer=ridx.center_scorer, nprobe=3,
        aligned_layout=False).search(jnp.asarray(qt), rs, 10)
    assert_topk_close(fused, ref_gathered, tol, "port fused vs ref gathered")
    assert_topk_close(gathered, ref_gathered, tol,
                      "port gathered vs ref gathered")
    # the reference's fine-step oracle on the same probe schedule
    rq = rs.prepare_queries(jnp.asarray(qt))
    probe = np.argsort(-np.asarray(rivf.coarse_scores(
        ridx, rivf.IVFQueryState(qstate=rq, q_coarse=None))), axis=1,
        kind="stable")[:, :3]
    sched = np.asarray(rs.list_block_ranges)[probe].reshape(len(qt), -1)
    if mode == "gleanvec-sorted":
        args = (rq, jnp.zeros(rq.shape[:2], jnp.float32), rs.block_tags,
                rs.perm, rs.x_low)
    else:
        args = (rq.q_scaled, rq.q_lo, rs.block_tags, rs.perm, rs.codes)
    oracle = r_ivf_scan_topk_ref(*args, jnp.asarray(sched), 10,
                                 layout_block=rs.layout_block)
    assert_topk_close(fused, oracle, tol, "port fused vs ivf_scan_topk_ref")
    assert_topk_close(gathered, oracle, tol,
                      "port gathered vs ivf_scan_topk_ref")
    live = _np(ps.inv_perm) >= 0
    ids = _np(fused[1])
    assert (ids >= 0).all() and live[ids].all()
