"""The port's graph index and its fused hop against the JAX reference.

The reference builds its graphs and encodes its scorers;
``repro_torch.convert`` carries them across, so both packages traverse the
same edges over the same codes. Checks:

* one hop: the port's plain ``graph_scan_beam_step`` against the reference's
  Pallas kernel (interpret mode) and its ``ref.py`` oracle, u8 and f32, with
  pads and repeated neighbor rows, dead rows, candidates already in the
  beam, beams that are not full and ``layout_block % tn != 0``; the
  gathered hop against the reference's on the same inputs;
* the builds: numpy NN-descent neighbors equal the reference's, the
  reverse-edge fill equals its sequential oracle, rows are duplicate-free,
  ``_detour_mask`` and ``_device_knn`` equal the reference's, and the
  device build's recall stays within 1 % of the numpy build's;
* the traversal on the carried-over graph and scorer: all 7 modes gathered
  and both sorted modes fused, expand 1 and 4, ID and OOD queries, with
  hop counts and Figure 7 tag traces equal to the reference's; the port's
  fused path equal to its gathered path; dead slots after ``remove_rows``;
* streamed growth: ``with_capacity`` shapes, ``insert_ids`` edge tables
  equal to the reference's (fused and gathered), an engine swap across an
  insert and refresh cycle that keeps every shape;
* the CLI: ``--fused-graph`` refused on a mode that is not sorted, and a
  ``--index graph --fused-graph --device cpu`` run.

Tolerances: scores are fp32 dot products summed in another order than the
reference's, so values agree within ``testing.dot_tol`` and top-k id sets
may differ only at near-ties of the k-th value
(``testing.assert_topk_close``). Where both sides are the port's own code
on the same inputs (fused against gathered), the results are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gleanvec as rgv
from repro.core import leanvec_sphering as rlvs
from repro.core import scorer as rsc
from repro.core import streaming as rst
from repro.data import vectors as rvectors
from repro.index import graph as rgraph
from repro.index.protocol import replace as rreplace
from repro.kernels.graph_scan import graph_scan_beam_step as rhop
from repro.kernels.graph_scan import beam_step_bytes as rbytes
from repro.kernels.graph_scan import fresh_slab_count as rslabs
from repro.kernels.graph_scan import (graph_scan_beam_step_ref,
                                      graph_scan_scores_ref)
from repro_torch import convert
from repro_torch import kernels as K
from repro_torch.core import metrics, search, streaming
from repro_torch.index import graph
from repro_torch.index.topk import NEG_INF
from repro_torch.launch import serve
from repro_torch.serve.engine import ServingEngine
from repro_torch.testing import assert_topk_close, dot_tol

MODES = ("full", "sphering", "gleanvec", "sphering-int8", "gleanvec-int8",
         "gleanvec-sorted", "gleanvec-int8-sorted")
SORTED = ("gleanvec-sorted", "gleanvec-int8-sorted")
N, D, C, DLOW, BLOCK = 800, 48, 4, 16, 64
BEAM, HOPS, NQ = 32, 64, 12


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.array(a))


def _norm(a):
    a = np.asarray(_np(a), np.float64)
    return float(np.linalg.norm(a.reshape(-1, a.shape[-1]), axis=1).max())


# ---------------------------------------------------------------------------
# One hop.
# ---------------------------------------------------------------------------

# Every case has pad slots, repeated neighbor rows, dead rows and
# candidates already in the beam.
HOP_CASES = {
    # name: (m, c, d, layout_block, n_blocks, s, b, full beam, tn)
    "full-beam-ragged-d": (5, 4, 33, 12, 9, 20, 16, True, 8),  # 12 % 8 != 0
    "beam-not-full": (4, 3, 16, 8, 8, 30, 24, False, 4),
}


def _hop_inputs(case, u8):
    m, c, d, lb, nb, s, b, full, _ = HOP_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)) + u8)
    n = lb * nb
    qs = rng.standard_normal((m, c, d)).astype(np.float32)
    qlo = rng.standard_normal((m, c)).astype(np.float32)
    btags = rng.integers(0, c, nb).astype(np.int32)
    rid = rng.permutation(n).astype(np.int32)
    rid[rng.random(n) < 0.15] = -1                     # dead rows
    codes = (rng.integers(0, 256, (n, d)).astype(np.uint8) if u8
             else rng.standard_normal((n, d)).astype(np.float32))
    nbr = rng.integers(0, n, (m, s)).astype(np.int32)
    nbr[rng.random((m, s)) < 0.2] = -1                 # pads anywhere
    nbr[:, 1] = nbr[:, 0]                              # repeated rows
    nbr[:, -1] = nbr[:, 2]
    beam_ids = np.full((m, b), -1, np.int32)
    beam_vals = np.full((m, b), NEG_INF, np.float32)
    live = b if full else b // 2
    for r in range(m):
        # some of this hop's candidates are already in the beam
        inbeam = list(dict.fromkeys(
            int(i) for i in rid[nbr[r][nbr[r] >= 0][:4]] if i >= 0))
        rest = [int(i) for i in rng.permutation(n) if i not in inbeam]
        ids = (inbeam + rest)[:live]
        beam_ids[r, :live] = ids
        beam_vals[r, :live] = rng.standard_normal(live) * 3
    return qs, qlo, btags, rid, codes, nbr, beam_vals, beam_ids, lb


def _hop_tol(qs, qlo, codes):
    return dot_tol(_norm(qs), _norm(codes.astype(np.float32)), qs.shape[2],
                   float(np.abs(qlo).max()))


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("case", list(HOP_CASES))
def test_hop_plain_matches_reference_kernel_and_oracle(case, u8):
    """The plain hop (the kernel's oracle on the card) equals the
    reference's Pallas kernel (interpret mode, its slab schedule and
    replace-the-minimum folds) and its ``ref.py``, as top-B multisets; the
    dense per-candidate scores equal ``graph_scan_scores_ref`` id for id."""
    args = _hop_inputs(case, u8)
    lb, tn = args[-1], HOP_CASES[case][-1]
    tol = _hop_tol(args[0], args[1], args[4])
    got = K.graph_scan_beam_step_plain(*map(_t, args[:-1]), lb)
    jargs = tuple(jnp.asarray(a) for a in args[:-1])
    pallas = rhop(*jargs, layout_block=lb, tn=tn, use_pallas=True,
                  interpret=True)
    oracle = graph_scan_beam_step_ref(*jargs, lb)
    assert_topk_close(got, pallas, tol, f"{case} vs Pallas")
    assert_topk_close(got, oracle, tol, f"{case} vs ref.py")
    # best first, as the kernel returns it
    v = _np(got[0])
    assert (np.diff(v, axis=1) <= 0).all()
    # the candidate scores, before the beam dedupe
    sv, si = K.graph_scan_scores_plain(*map(_t, args[:6]), lb)
    rv, ri = graph_scan_scores_ref(*jargs[:6], lb)
    np.testing.assert_array_equal(_np(si), np.asarray(ri))
    np.testing.assert_allclose(_np(sv), np.asarray(rv), rtol=0, atol=tol)
    # the reference kernel's traffic model, as arithmetic
    from repro_torch.kernels.graph_scan import (beam_step_bytes,
                                                fresh_slab_count)
    m, c, d, _, _, s, b = HOP_CASES[case][:7]
    slabs = fresh_slab_count(_t(args[5]), tn)
    assert slabs == rslabs(args[5], tn) > 0
    assert beam_step_bytes(m, slabs, tn, d, c, b, s, 1 + 3 * (not u8)) \
        == rbytes(m, slabs, tn, d, c, b, s, 1 + 3 * (not u8))


def test_hop_wrapper_takes_plain_on_cpu_and_counts_nothing():
    args = _hop_inputs("beam-not-full", False)
    before = (K.graph_scan_beam_step.launches, K.graph_beam_search.launches)
    got = K.graph_scan_beam_step(*map(_t, args[:-1]), layout_block=args[-1],
                                 tn=8)
    want = K.graph_scan_beam_step_plain(*map(_t, args[:-1]), args[-1])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (K.graph_scan_beam_step.launches,
            K.graph_beam_search.launches) == before


# ---------------------------------------------------------------------------
# The carried-over world: dataset, models, scorers, graph.
# ---------------------------------------------------------------------------


class _World:
    def __init__(self):
        self.ds = rvectors.make_dataset("graph-scan", n=N, d=D,
                                        n_queries=64, ood=True, seed=5)
        self.x = jnp.asarray(self.ds.database)
        q = jnp.asarray(self.ds.queries_learn)
        self.models = {"sphering": rlvs.fit(q, self.x, DLOW),
                       "gleanvec": rgv.fit(jax.random.PRNGKey(0), q, self.x,
                                           c=C, d=DLOW)}
        self.g = rgraph.build(self.ds.database, r=16, n_iters=4, seed=0)
        self._scorers = {}

    def model(self, mode):
        if mode == "full":
            return None
        return self.models["sphering" if mode.startswith("sphering")
                           else "gleanvec"]

    def scorer(self, mode):
        if mode not in self._scorers:
            s = rsc.build_scorer(mode, self.x, self.model(mode), block=BLOCK)
            self._scorers[mode] = (s, convert.scorer(
                type(s).__name__, convert.arrays_of(s), "cpu"))
        return self._scorers[mode]

    def queries(self, kind):
        return (self.ds.queries_test[:NQ] if kind == "ood"
                else self.ds.database[:NQ] + 0.01)


@pytest.fixture(scope="module")
def world():
    return _World()


def _state_tol(qstate, scorer):
    qs, lo = qstate, 0.0
    if isinstance(qstate, tuple):
        qs, lo = qstate.q_scaled, float(_np(qstate.q_lo).__abs__().max())
    rows = scorer.x_low if hasattr(scorer, "x_low") else scorer.codes
    return dot_tol(_norm(qs), _norm(rows.to(torch.float32)), rows.shape[1],
                   lo)


def test_gathered_hop_matches_reference(world):
    """One gathered hop (gather, score, beam dedupe, stable merge) on the
    same inputs: the reference's ``gathered_beam_step`` and the port's."""
    rs, ps = world.scorer("gleanvec-int8-sorted")
    q = world.queries("ood")
    rq, pq = rs.prepare_queries(jnp.asarray(q)), ps.prepare_queries(_t(q))
    rng = np.random.default_rng(3)
    m, beam, e = q.shape[0], BEAM, 4
    ids = np.stack([rng.permutation(N)[:beam] for _ in range(m)]).astype(
        np.int32)
    ids[:, beam - 5:] = -1
    vals = rng.standard_normal((m, beam)).astype(np.float32)
    vals[:, beam - 5:] = NEG_INF
    visited = rng.random((m, beam)) < 0.3
    best = np.stack([rng.permutation(N)[:e] for _ in range(m)]).astype(
        np.int32)
    best[:, 0] = ids[:, 0]                 # a popped vertex from the beam
    sel_ok = rng.random((m, e)) < 0.8
    nbrs = np.asarray(world.g.neighbors)

    def rscore(c):
        return rs.score_ids(rq, jnp.where(c >= 0, c, 0))

    def pscore(c):
        return ps.score_ids(pq, torch.where(c >= 0, c, torch.zeros_like(c)))

    want = jax.jit(lambda *a: rgraph.gathered_beam_step(rscore, *a, beam))(
        jnp.asarray(nbrs), jnp.asarray(vals), jnp.asarray(ids),
        jnp.asarray(visited), jnp.asarray(best), jnp.asarray(sel_ok))
    got = graph.gathered_beam_step(pscore, _t(nbrs), _t(vals), _t(ids),
                                   _t(visited), _t(best), _t(sel_ok), beam)
    tol = _state_tol(pq, ps)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=0,
                               atol=tol)


# ---------------------------------------------------------------------------
# Builds.
# ---------------------------------------------------------------------------


def test_numpy_build_matches_reference(world):
    """Same seed, same numpy draws: the neighbor table equals the
    reference's exactly (the entry points come from each package's own
    k-means seeding and may differ)."""
    g = graph.build(world.ds.database, r=16, n_iters=4, seed=0, device="cpu")
    np.testing.assert_array_equal(_np(g.neighbors),
                                  np.asarray(world.g.neighbors))
    assert g.entries.dtype == torch.int32 and g.entries.ndim == 1
    assert len(set(_np(g.entries).tolist())) == g.entries.shape[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reverse_edge_fill_matches_sequential_oracle(seed):
    """Front-packed rows with duplicate forward edges, empty rows and full
    rows: the vectorized fill equals the sequential oracle and the
    reference's, exactly."""
    rng = np.random.default_rng(seed)
    n, r = 120, 8
    nbrs = rng.integers(0, n, size=(n, r)).astype(np.int64)
    fill = rng.integers(0, r + 1, size=n)
    nbrs[np.arange(r)[None, :] >= fill[:, None]] = -1
    nbrs[:7] = -1
    nbrs[7] = rng.integers(0, n)
    got = graph._reverse_edge_fill(nbrs.copy(), r)
    np.testing.assert_array_equal(got, graph._reverse_edge_fill_ref(
        nbrs.copy(), r))
    np.testing.assert_array_equal(got, rgraph._reverse_edge_fill(
        nbrs.copy(), r))


def test_dedupe_rows_contract(world):
    """The built rows are duplicate-free, and ``_dedupe_rows`` keeps the
    first occurrence, as the reference's."""
    for row in _np(graph.build(world.ds.database[:300], r=8, n_iters=2,
                               seed=1, device="cpu").neighbors):
        live = row[row >= 0]
        assert live.size == np.unique(live).size
    rows = np.random.default_rng(4).integers(-1, 6, (50, 9))
    np.testing.assert_array_equal(graph._dedupe_rows(rows),
                                  rgraph._dedupe_rows(rows))


def test_device_knn_and_detour_mask_match_reference():
    """The self-join's k-NN lists agree with the reference's as top-k sets
    of the augmented inner product (ids may differ at near-ties, scored
    here in float64, within ``dot_tol`` of the (d + 1)-wide products), and
    the rank-based detour mask equals the reference's on the same table."""
    ds = rvectors.make_dataset("graph-build", n=500, d=24, n_queries=8,
                               ood=True, seed=7)
    x = np.asarray(ds.database, np.float64)
    want = rgraph._device_knn(ds.database, 20, batch=128)
    got = _np(graph._device_knn(_t(ds.database), 20, batch=128))
    aug = np.concatenate([x, -0.5 * np.sum(x * x, 1, keepdims=True)], 1)
    q = np.concatenate([x, np.ones((x.shape[0], 1))], 1)

    def scored(ids):
        return np.einsum("nkd,nd->nk", aug[ids], q), ids

    assert_topk_close(scored(got), scored(want),
                      dot_tol(_norm(q), _norm(aug), aug.shape[1]),
                      "device k-NN")
    knn = jnp.asarray(want.astype(np.int32))
    for s in (0, 250, 480):
        np.testing.assert_array_equal(
            _np(graph._detour_mask(_t(want), _t(want[s:s + 20]))),
            np.asarray(rgraph._detour_mask(knn, knn[s:s + 20])))


def test_device_build_recall_matches_numpy():
    """The CAGRA-style device build (here on the CPU: the self-join's plain
    version) holds recall@10 within 1 % of the numpy NN-descent build at a
    matched beam, on bimodal data (the reference's own test)."""
    ds = rvectors.make_dataset("graph-build", n=1200, d=48, n_queries=128,
                               ood=True, seed=7)
    x = _t(ds.database)
    q = _t(ds.queries_test)
    scorer = convert.scorer("LinearScorer", {"x_low": ds.database}, "cpu")
    gt = torch.topk(q @ x.T, 10, dim=1).indices.numpy()
    g_np = graph.build(ds.database, r=16, n_iters=4, seed=0,
                       method="numpy", device="cpu")
    timings = {}
    g_dev = graph.build_device(ds.database, r=16, seed=0, device="cpu",
                               timings=timings)
    assert g_np.neighbors.shape == g_dev.neighbors.shape
    assert set(timings) == {"self_join", "detour_prune", "reverse_fill",
                            "entry_points"}

    def recall(g):
        _, ids = dataclasses.replace(g, beam=BEAM, max_hops=128).search(
            q, scorer, 10)
        return metrics.recall_at_k(_np(ids), gt)

    r_np, r_dev = recall(g_np), recall(g_dev)
    assert r_np > 0.85, f"numpy build recall degenerate: {r_np:.3f}"
    assert r_dev >= r_np - 0.01, f"device {r_dev:.3f} vs numpy {r_np:.3f}"


# ---------------------------------------------------------------------------
# The traversal.
# ---------------------------------------------------------------------------

TRAVERSALS = [(m, False) for m in MODES] + [(m, True) for m in SORTED]


def _graphs(world, mode, expand, fused):
    rs, _ = world.scorer(mode)
    rg = rreplace(world.g, beam=BEAM, max_hops=HOPS, expand=expand)
    if fused:
        rg = rgraph.with_fused_scan(rg, rs)
    return rg, convert.graph_index(rg, "cpu")


@pytest.mark.parametrize("qkind", ["id", "ood"])
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("mode,fused", TRAVERSALS,
                         ids=[f"{m}-{'fused' if f else 'gathered'}"
                              for m, f in TRAVERSALS])
def test_traversal_matches_reference(world, mode, fused, expand, qkind):
    """The whole traversal on the carried-over graph and scorer: the same
    hop count, the same candidates (within ``dot_tol``), and for the tagged
    scorers the same Figure 7 tag trace."""
    rs, ps = world.scorer(mode)
    rg, pg = _graphs(world, mode, expand, fused)
    assert pg.fused == fused and (pg.nbr_rows is None) != fused
    q = world.queries(qkind)
    trace = hasattr(ps, "tags")
    want = rgraph._beam_qstate(rs.prepare_queries(jnp.asarray(q)), rs, rg,
                               10, BEAM, HOPS, expand=expand,
                               trace_tags=rs.tags if trace else None)
    pq = ps.prepare_queries(_t(q))
    got = graph._beam_qstate(pq, ps, pg, 10, BEAM, HOPS, expand=expand,
                             trace_tags=ps.tags if trace else None)
    assert got[2] == int(want[2]) > 0
    assert_topk_close(got[:2], want[:2], _state_tol(pq, ps),
                      f"{mode}/fused={fused}/expand={expand}/{qkind}")
    if trace:
        np.testing.assert_array_equal(_np(got[3]), np.asarray(want[3]))


def test_traced_wrappers_match_reference(world):
    """``beam_search_traced`` and ``beam_search_scorer(trace=True)``: hop
    count and tag trace equal the reference's; ``trace`` needs tags."""
    rs, ps = world.scorer("gleanvec")
    q = world.queries("ood")
    rq = rs.prepare_queries(jnp.asarray(q))
    rg = rreplace(world.g, beam=BEAM, max_hops=HOPS)
    pg = convert.graph_index(rg, "cpu")
    want = rgraph.beam_search_traced(rq, rs.tags, rs.x_low, rg, 10, BEAM,
                                     HOPS)
    got = graph.beam_search_traced(ps.prepare_queries(_t(q)), ps.tags,
                                   ps.x_low, pg, 10, BEAM, HOPS)
    assert got[2] == int(want[2])
    np.testing.assert_array_equal(_np(got[3]), np.asarray(want[3]))
    got2 = graph.beam_search_scorer(_t(q), ps, pg, 10, beam=BEAM,
                                    max_hops=HOPS, trace=True)
    assert got2[2] == got[2] and torch.equal(got2[3], got[3])
    _, fs = world.scorer("full")
    with pytest.raises(ValueError, match="tagged"):
        graph.beam_search_scorer(_t(q), fs, pg, 10, trace=True)
    lin = graph.beam_search(_t(q), fs.x_low, pg, 10, BEAM, HOPS)
    assert_topk_close(lin, rgraph.beam_search(jnp.asarray(q), fs.x_low.numpy(),
                                              rg, 10, BEAM, HOPS),
                      _state_tol(_t(q), fs), "beam_search")


def _same_result(a, b, label):
    """Equal per-row value lists and id sets (the two hops may order exact
    ties differently)."""
    va, vb = _np(a[0]), _np(b[0])
    np.testing.assert_array_equal(-np.sort(-va, 1), -np.sort(-vb, 1), label)
    for r in range(va.shape[0]):
        assert set(_np(a[1][r]).tolist()) == set(_np(b[1][r]).tolist()), \
            (label, r)


@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("mode", SORTED)
def test_port_fused_equals_port_gathered(world, mode, expand):
    """The port's fused hop and its gathered hop compute the same scores in
    the same order on the CPU: whole traversals agree exactly (hop count,
    values, id sets)."""
    _, ps = world.scorer(mode)
    pg = dataclasses.replace(convert.graph_index(world.g, "cpu"), beam=BEAM,
                             max_hops=HOPS, expand=expand)
    fused = graph.with_fused_scan(pg, ps)
    q = np.concatenate([world.queries("id"), world.queries("ood")])
    pq = ps.prepare_queries(_t(q))
    a = graph._beam_qstate(pq, ps, fused, 10, BEAM, HOPS, expand=expand)
    b = graph._beam_qstate(pq, ps, pg, 10, BEAM, HOPS, expand=expand)
    assert a[2] == b[2]
    _same_result(a, b, f"{mode}/expand={expand}")
    assert not bool((a[1] < 0).all())


@pytest.mark.parametrize("mode", SORTED)
def test_fused_streamed_dead_slots(world, mode):
    """``remove_rows`` then ``refreshed``: the re-derived fused graph agrees
    with the gathered traversal, no removed id is returned, and both agree
    with the reference's own churned traversal."""
    rs, _ = world.scorer(mode)
    gvm = world.models["gleanvec"]
    rart = rst.build_streaming_artifacts(mode, world.x, gvm,
                                         sort_block=BLOCK)
    entries = set(np.asarray(world.g.entries).tolist())
    rm = np.array([i for i in range(0, N, 13) if i not in entries],
                  np.int32)[:60]
    rart = rst.remove_rows(rart, rm)
    ps = convert.scorer(type(rart.scorer).__name__,
                        convert.arrays_of(rart.scorer), "cpu")
    rg = rreplace(world.g, beam=BEAM, max_hops=HOPS, expand=4)
    pg = convert.graph_index(rg, "cpu")
    fused = graph.with_fused_scan(pg, world.scorer(mode)[1])   # pre-churn
    fused = fused.refreshed(ps, None)
    q = _t(world.queries("ood"))
    res_f = fused.search(q, ps, 10)
    res_g = pg.search(q, ps, 10)
    _same_result(res_f, res_g, f"{mode}/streamed")
    assert not np.isin(_np(res_f[1]), rm).any()
    want = rgraph.with_fused_scan(rg, rart.scorer).search(
        jnp.asarray(world.queries("ood")), rart.scorer, 10)
    assert_topk_close(res_f, want, _state_tol(ps.prepare_queries(q), ps),
                      f"{mode}/streamed vs reference")


def test_scan_neighbors_lowering_refuses_other_scorers(world):
    _, ps = world.scorer("gleanvec-int8")
    with pytest.raises(TypeError, match="scan_neighbors"):
        K.scorer_scan_neighbors(ps, None, None, None, None)


# ---------------------------------------------------------------------------
# Streamed growth.
# ---------------------------------------------------------------------------

N0, CAP, INSERTS = 400, 512, 48


@pytest.fixture(scope="module")
def grow():
    ds = rvectors.make_dataset("graph-insert", n=CAP, d=D, n_queries=64,
                               ood=True, seed=5)
    x = jnp.asarray(ds.database)
    gvm = rgv.fit(jax.random.PRNGKey(0), jnp.asarray(ds.queries_learn),
                  x[:N0], c=4, d=16)
    g = rreplace(rgraph.build(ds.database[:N0], r=8, n_iters=4, seed=0),
                 beam=32, max_hops=64, expand=4)
    return ds, x, gvm, g


def test_with_capacity_shapes(grow):
    _, _, _, rg = grow
    g = convert.graph_index(rg, "cpu")
    r_built = g.neighbors.shape[1]
    padded = graph.with_capacity(g, CAP)
    assert tuple(padded.neighbors.shape) == (CAP, r_built)
    assert bool((padded.neighbors[N0:] == -1).all())
    assert torch.equal(padded.neighbors[:N0], g.neighbors)
    assert graph.with_capacity(g, N0) is g
    with pytest.raises(ValueError, match="capacity"):
        graph.with_capacity(g, N0 - 1)
    np.testing.assert_array_equal(_np(padded.neighbors), np.asarray(
        rgraph.with_capacity(rg, CAP).neighbors))


@pytest.mark.parametrize("mode,fused", [("gleanvec-int8", False),
                                        ("gleanvec-int8-sorted", True)])
def test_insert_ids_matches_reference(grow, mode, fused):
    """``insert_ids`` on the carried-over store and graph: the edge table
    (and a fused graph's ``nbr_rows``) equals the reference's exactly; every
    inserted id has out-edges and at least one in-edge."""
    ds, x, gvm, rg = grow
    rart = rst.build_streaming_artifacts(mode, x[:N0], gvm, capacity=CAP,
                                         sort_block=BLOCK, slack_blocks=2)
    rows = x[N0:N0 + INSERTS]
    rart, new_ids = rst.insert_rows(rart, rows)
    rgc = rgraph.with_capacity(rg, CAP)
    if fused:
        rgc = rgraph.with_fused_scan(rgc, rart.scorer)
    want = rgraph.insert_ids(rgc, rows, np.asarray(new_ids), rart.scorer,
                             rart.x_full)
    ps = convert.scorer(type(rart.scorer).__name__,
                        convert.arrays_of(rart.scorer), "cpu")
    got = graph.insert_ids(convert.graph_index(rgc, "cpu"), _t(rows),
                           _t(new_ids), ps, _t(rart.x_full))
    np.testing.assert_array_equal(_np(got.neighbors),
                                  np.asarray(want.neighbors))
    assert got.fused == fused
    if fused:
        np.testing.assert_array_equal(_np(got.nbr_rows),
                                      np.asarray(want.nbr_rows))
    nb = _np(got.neighbors)
    ids = np.asarray(new_ids)
    assert (nb[ids] >= 0).any(axis=1).all()
    assert all(np.isin(i, np.delete(nb, i, axis=0)) for i in ids)


def test_engine_swap_across_insert_and_refresh(grow):
    """A fused graph behind the ServingEngine: an insert cycle (store rows
    + ``insert_ids``) and a refresh (``refresh_state`` -> ``refreshed``)
    swap in with every shape, dtype and device kept, the entries' storage
    shared, and the engine still answering; a graph without ``nbr_rows``
    is refused as a structure change."""
    ds, x, gvm, rg = grow
    model = convert.gleanvec_model(convert.arrays_of(gvm), "cpu")
    xs = ds.database
    arts = streaming.build_streaming_artifacts(
        "gleanvec-int8-sorted", xs[:N0], model, capacity=CAP,
        sort_block=BLOCK, slack_blocks=2, device="cpu")
    g = graph.with_fused_scan(graph.with_capacity(
        convert.graph_index(rg, "cpu"), CAP), arts.scorer)
    engine = ServingEngine(search.make_state(arts, index=g), k=10, kappa=20,
                           batch_size=16, dim=D)
    q = ds.queries_test[:16]
    engine.submit(q)
    shapes = {f: tuple(getattr(g, f).shape) for f in ("neighbors",
                                                      "entries", "nbr_rows")}
    arts2, new_ids = streaming.insert_rows(arts, _t(xs[N0:]))
    g2 = graph.insert_ids(g, _t(xs[N0:]), new_ids, arts2.scorer,
                          arts2.x_full)
    engine.swap(engine.state._replace(artifacts=arts2, index=g2))
    stream = streaming.refresh(streaming.init_from_artifacts(arts2, q))
    st3 = streaming.refresh_state(engine.state, stream)
    engine.swap(st3)
    g3 = engine.state.index
    assert engine.version == 2 and g3.fused
    for f, shp in shapes.items():
        assert tuple(getattr(g3, f).shape) == shp, f
        assert getattr(g3, f).dtype == torch.int32
    assert g3.entries.data_ptr() == g.entries.data_ptr()
    out = engine.submit(q)
    assert out.shape == (16, 10) and (out >= 0).all()
    with pytest.raises(ValueError, match="structure"):
        engine.swap(engine.state._replace(
            index=dataclasses.replace(g3, nbr_rows=None)))
    with pytest.raises(ValueError, match="structure"):
        engine.swap(engine.state._replace(
            index=dataclasses.replace(g3, expand=1)))


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------


def test_cli_refuses_fused_graph_on_unsorted_mode():
    with pytest.raises(SystemExit, match="sorted"):
        serve.main(["--mode", "gleanvec", "--index", "graph",
                    "--fused-graph", "--n", "300", "--dim", "16", "--d", "4",
                    "--clusters", "4", "--device", "cpu"])


def test_cli_graph_fused_cpu(capsys):
    serve.main(["--mode", "gleanvec-int8-sorted", "--index", "graph",
                "--fused-graph", "--n", "600", "--dim", "32", "--d", "8",
                "--clusters", "4", "--batch", "256", "--kappa", "20",
                "--beam", "32", "--expand", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "index=graph" in out
    rec = float(out.split("recall@10=")[1].split()[0])
    assert rec >= 0.9, out
