"""The port's IVF index against the JAX reference.

The reference fits and encodes once per query kind (ID / OOD), builds its
IVF indexes, and ``repro_torch.convert`` carries scorers and indexes
across, so both packages probe the same centers and score the same codes.
Checks:

* the host-side tables (``_pack_lists``, ``_list_block_ranges``,
  ``sort_by_tag`` with slack blocks) equal the reference's exactly;
* ``score_ids`` of all six scorers and ``coarse_scores`` (full-D and
  reduced-space probe) against the reference;
* the aligned IVF search (the fused ``scan_lists`` fine step; on CPU its
  plain version) against the reference's for both sorted modes, ID and
  OOD, slack 0 and 2, with and without the reduced probe; the gathered
  fine step against the reference's for all 7 modes; the port's fused
  against its gathered step (unchurned stores, so ROADMAP C1 cannot
  arise);
* ``ServingEngine`` over IVF against the reference engine, and its swap
  check on IVF indexes.

Tolerance: fp32 products summed in another order (``testing.dot_tol``);
ids may differ only at near-ties of the k-th value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gleanvec as rgv
from repro.core import leanvec_sphering as rlvs
from repro.core import metrics as rmetrics
from repro.core import scorer as rsc
from repro.core import search as rsearch
from repro.data import vectors as rvectors
from repro.index import ivf as rivf
from repro.index.protocol import replace as rreplace
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch import convert
from repro_torch.core import gleanvec as gv
from repro_torch.core import metrics, search
from repro_torch.core import scorer as sc
from repro_torch.core.scorer import MODES, QuantQueryState
from repro_torch.index import ivf
from repro_torch.serve.engine import ServingEngine
from repro_torch.testing import assert_topk_close, dot_tol

N, D, DR, C, BLOCK, NPROBE, KAPPA, K = 2048, 64, 16, 8, 64, 3, 40, 10
SORTED = ("gleanvec-sorted", "gleanvec-int8-sorted")


class _Case:
    def __init__(self, ood: bool):
        self.ds = rvectors.make_dataset("ivf", n=N, d=D, n_queries=96,
                                        ood=ood, seed=5)
        self.x = jnp.asarray(self.ds.database)
        q = jnp.asarray(self.ds.queries_learn)
        self.models = {
            "sphering": rlvs.fit(q, self.x, DR),
            "gleanvec": rgv.fit(jax.random.PRNGKey(0), q, self.x, c=C, d=DR,
                                kmeans_iters=6),
        }
        self.queries = self.ds.queries_test[:16]
        self.kmeans_ivf = rivf.build(jax.random.PRNGKey(1), self.x, n_lists=C,
                                     n_iters=6, nprobe=NPROBE)
        self._arts = {}

    def model(self, mode):
        if mode == "full":
            return None
        return self.models["sphering" if mode.startswith("sphering")
                           else "gleanvec"]

    def artifacts(self, mode, slack=0):
        key = (mode, slack)
        if key not in self._arts:
            model = self.model(mode)
            if mode == "gleanvec-sorted":
                s = rsc.sorted_gleanvec_scorer(model, self.x, block=BLOCK,
                                               slack_blocks=slack)
            elif mode == "gleanvec-int8-sorted":
                s = rsc.sorted_gleanvec_quantized_scorer(
                    model, self.x, block=BLOCK, slack_blocks=slack)
            else:
                s = rsc.build_scorer(mode, self.x, model)
            self._arts[key] = rsearch.SearchArtifacts(scorer=s, x_full=self.x,
                                                      model=model)
        return self._arts[key]


@pytest.fixture(scope="module")
def cases():
    return {False: _Case(False), True: _Case(True)}


def _port_scorer(s):
    return convert.scorer(type(s).__name__, convert.arrays_of(s), "cpu")


def _port_model(model, mode):
    if model is None:
        return None
    build = convert.sphering_model if mode.startswith("sphering") \
        else convert.gleanvec_model
    return build(convert.arrays_of(model), "cpu")


def _port_artifacts(ref_art, mode):
    return search.SearchArtifacts(
        scorer=_port_scorer(ref_art.scorer),
        x_full=torch.from_numpy(np.array(ref_art.x_full)),
        model=_port_model(ref_art.model, mode))


def _norm(t):
    t = t.to(torch.float32)
    return float(torch.linalg.norm(t.reshape(-1, t.shape[-1]), dim=1).max())


def _tol(scorer, qstate):
    """fp32 reordering bound of the fine step's scores."""
    qs = qstate.q_scaled if isinstance(qstate, QuantQueryState) else qstate
    rows = scorer.x_low if hasattr(scorer, "x_low") else scorer.codes
    lo = float(qstate.q_lo.abs().max()) \
        if isinstance(qstate, QuantQueryState) else 0.0
    return dot_tol(_norm(qs), _norm(rows), rows.shape[1], lo)


def _exact(queries, x, ids):
    safe = np.where(ids >= 0, ids, 0)
    s = np.einsum("md,mkd->mk", queries.astype(np.float64), x[safe])
    return np.where(ids >= 0, s, -3.4e38)


@pytest.mark.parametrize("slack", [0, 2])
def test_tables_match_reference(slack):
    """``sort_by_tag`` (with slack blocks), ``_list_block_ranges`` and
    ``_pack_lists`` equal the reference's exactly."""
    rng = np.random.default_rng(slack)
    tags = rng.integers(0, 6, 700).astype(np.int32)
    tags[tags == 4] = 3                      # an empty cluster in the middle
    x = rng.standard_normal((700, 5)).astype(np.float32)
    xs, bt, perm = gv.sort_by_tag(torch.from_numpy(tags),
                                  torch.from_numpy(x), block=64,
                                  slack_blocks=slack)
    rxs, rbt, rperm, _ = rgv.sort_by_tag(jnp.asarray(tags), jnp.asarray(x),
                                         block=64, slack_blocks=slack)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(rxs))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(rbt))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(rperm))
    for c in (6, 8):                         # C above the largest tag too
        np.testing.assert_array_equal(
            sc._list_block_ranges(bt, c).numpy(),
            np.asarray(rsc._list_block_ranges(rbt, c)))
        np.testing.assert_array_equal(
            ivf._pack_lists(torch.from_numpy(tags), c).numpy(),
            rivf._pack_lists(tags, c))


@pytest.mark.parametrize("mode", MODES)
def test_score_ids_and_coarse_scores_match(cases, mode):
    """``score_ids`` on ORIGINAL ids (every scorer class) and the coarse
    probe scores, full-D and through the scorer's reduced centers."""
    case = cases[True]
    ref_art = case.artifacts(mode)
    scorer = _port_scorer(ref_art.scorer)
    q_np = case.queries
    qstate = scorer.prepare_queries(torch.from_numpy(q_np))
    ref_q = ref_art.scorer.prepare_queries(jnp.asarray(q_np))
    ids = np.random.default_rng(1).integers(0, N, (16, 50)).astype(np.int32)
    got = scorer.score_ids(qstate, torch.from_numpy(ids)).numpy()
    want = np.asarray(ref_art.scorer.score_ids(ref_q, jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_tol(scorer, qstate))

    ref_idx = case.kmeans_ivf
    idx = convert.ivf_index(ref_idx, "cpu")
    full = ivf.coarse_scores(idx, idx.prepare_queries(
        scorer, torch.from_numpy(q_np)))
    ref_full = rivf.coarse_scores(ref_idx, ref_idx.prepare_queries(
        ref_art.scorer, jnp.asarray(q_np)))
    np.testing.assert_allclose(full.numpy(), np.asarray(ref_full), rtol=0,
                               atol=dot_tol(float(np.linalg.norm(
                                   q_np, axis=1).max()), 1.0, D))
    model = _port_model(ref_art.model, mode)
    red = ivf.with_reduced_centers(idx, scorer, model)
    ref_red = rivf.with_reduced_centers(ref_idx, ref_art.scorer,
                                        ref_art.model)
    assert type(red.center_scorer).__name__ == \
        type(ref_red.center_scorer).__name__
    assert convert.ivf_index(ref_red, "cpu").center_scorer is not None
    got = ivf.coarse_scores(red, red.prepare_queries(
        scorer, torch.from_numpy(q_np)))
    want = rivf.coarse_scores(ref_red, ref_red.prepare_queries(
        ref_art.scorer, jnp.asarray(q_np)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("ood", [False, True], ids=["ID", "OOD"])
@pytest.mark.parametrize("mode", MODES)
def test_gathered_ivf_matches_reference(cases, mode, ood):
    """The gathered fine step (``score_ids`` over the probed posting lists)
    of a k-means IVF carried across from the reference, all 7 modes."""
    case = cases[ood]
    ref_art = case.artifacts(mode)
    scorer = _port_scorer(ref_art.scorer)
    idx = convert.ivf_index(case.kmeans_ivf, "cpu")
    assert not idx.aligned_layout and idx.nprobe == NPROBE
    q = torch.from_numpy(case.queries)
    port = idx.search(q, scorer, KAPPA)
    ref = case.kmeans_ivf.search(jnp.asarray(case.queries), ref_art.scorer,
                                 KAPPA)
    tol = _tol(scorer, scorer.prepare_queries(q))
    assert_topk_close(port, ref, tol, f"{mode} gathered IVF")
    np.testing.assert_array_equal(port[1].numpy() < 0, np.asarray(ref[1]) < 0)


@pytest.mark.parametrize("slack", [0, 2])
@pytest.mark.parametrize("ood", [False, True], ids=["ID", "OOD"])
@pytest.mark.parametrize("mode", SORTED)
def test_aligned_ivf_matches_reference(cases, mode, ood, slack):
    """Aligned IVF: the fused fine step (``scan_lists`` -> ``ivf_scan_topk``)
    with and without the reduced probe, and the gathered step on the same
    index, against the reference's; the port's fused step against its
    gathered one."""
    case = cases[ood]
    ref_art = case.artifacts(mode, slack)
    scorer = _port_scorer(ref_art.scorer)
    assert scorer.list_block_ranges is not None
    ref_idx = rivf.build_aligned(ref_art.model, case.x, nprobe=NPROBE + 1)
    model = _port_model(ref_art.model, mode)
    own = ivf.build_aligned(model, torch.from_numpy(case.ds.database),
                            nprobe=NPROBE + 1, device="cpu")
    np.testing.assert_array_equal(own.lists.numpy(), np.asarray(ref_idx.lists))
    assert own.aligned_layout and own.nprobe == NPROBE + 1
    q = torch.from_numpy(case.queries)
    jq = jnp.asarray(case.queries)
    tol = _tol(scorer, scorer.prepare_queries(q))
    results = {}
    for reduced in (False, True):
        r_idx = rivf.with_reduced_centers(ref_idx, ref_art.scorer,
                                          ref_art.model) \
            if reduced else ref_idx
        p_idx = ivf.with_reduced_centers(own, scorer, model) \
            if reduced else own
        fused = p_idx.search(q, scorer, KAPPA)
        assert_topk_close(fused, r_idx.search(jq, ref_art.scorer, KAPPA),
                          tol, f"{mode} fused reduced={reduced}")
        results[reduced] = fused
    gathered = dataclasses.replace(own, aligned_layout=False).search(
        q, scorer, KAPPA)
    assert_topk_close(gathered, rreplace(ref_idx, aligned_layout=False)
                      .search(jq, ref_art.scorer, KAPPA), tol,
                      f"{mode} gathered")
    assert_topk_close(results[False], gathered, tol, "port fused vs gathered")
    assert_topk_close(results[False], results[True], tol,
                      "full-D vs reduced probe")


def test_fused_unfilled_slots_strip_to_minus_one(cases):
    """Fewer valid rows than k: -inf winners carry id -1."""
    case = cases[True]
    model = _port_model(case.models["gleanvec"], "gleanvec-sorted")
    x = torch.from_numpy(case.ds.database[:64])
    s = sc.sorted_gleanvec_scorer(model, x, block=64)
    idx = ivf.build_aligned(model, x, nprobe=1, device="cpu")
    vals, ids = idx.search(torch.from_numpy(case.queries[:4]), s, 60)
    assert (ids[vals <= -3.4e38] == -1).all() and (ids >= 0).any()
    assert (vals > -3.4e38).sum(dim=1).max() <= 64


@pytest.mark.parametrize("mode", SORTED)
def test_engine_over_ivf_matches_reference(cases, mode):
    """``multi_step_search`` and ``ServingEngine`` over the aligned IVF with
    the reduced probe: same final ids (through their exact scores) and
    recall as the reference engine."""
    case = cases[True]
    ref_art = case.artifacts(mode)
    ref_idx = rivf.with_reduced_centers(
        rivf.build_aligned(ref_art.model, case.x, nprobe=NPROBE),
        ref_art.scorer, ref_art.model)
    art = _port_artifacts(ref_art, mode)
    idx = convert.ivf_index(ref_idx, "cpu")
    q_np = case.queries
    ids = search.multi_step_search(torch.from_numpy(q_np), art, idx, K,
                                   KAPPA).numpy()
    eng = ServingEngine(search.make_state(art, index=idx), k=K, kappa=KAPPA,
                        batch_size=6, dim=D)
    ref_eng = RefEngine(rsearch.make_state(ref_art, index=ref_idx), k=K,
                        kappa=KAPPA, batch_size=6, dim=D)
    got, want = eng.submit(q_np), np.asarray(ref_eng.submit(q_np))
    np.testing.assert_array_equal(got, ids)
    x = case.ds.database
    full_tol = dot_tol(float(np.linalg.norm(q_np, axis=1).max()),
                       float(np.linalg.norm(x, axis=1).max()), D)
    assert_topk_close((_exact(q_np, x, got), got),
                      (_exact(q_np, x, want), want), full_tol,
                      f"{mode} engine over IVF")
    gt = case.ds.gt[:16, :K]
    rec_ref = float(rmetrics.recall_at_k(jnp.asarray(want), jnp.asarray(gt)))
    assert abs(metrics.recall_at_k(got, gt) - rec_ref) <= 0.002


def test_engine_swap_checks_ivf_index(cases):
    """A swap to an IVF index with other list shapes, ``nprobe``, fine-step
    mode or probe companion raises before touching the engine; a rebuilt
    index of the same structure is accepted."""
    case = cases[True]
    mode = "gleanvec-int8-sorted"
    ref_art = case.artifacts(mode)
    art = _port_artifacts(ref_art, mode)
    idx = ivf.build_aligned(art.model, art.x_full, nprobe=NPROBE,
                            device="cpu")
    eng = ServingEngine(search.make_state(art, index=idx), k=K, kappa=KAPPA,
                        batch_size=8, dim=D)
    rebuilt = ivf.build_aligned(art.model, art.x_full, nprobe=NPROBE,
                                device="cpu")
    eng.swap(search.make_state(art, index=rebuilt))
    assert eng.version == 1 and eng.n_swaps == 1
    wider = torch.nn.functional.pad(idx.lists, (0, 3), value=-1)
    for bad in (dataclasses.replace(idx, lists=wider),
                dataclasses.replace(idx, nprobe=NPROBE + 1),
                dataclasses.replace(idx, aligned_layout=False),
                ivf.with_reduced_centers(idx, art.scorer, art.model)):
        with pytest.raises(ValueError, match="swap would change"):
            eng.swap(search.make_state(art, index=bad))
    assert eng.version == 1 and eng.n_swaps == 1 and eng.state.index is rebuilt


def test_port_builds_its_own_kmeans_ivf(cases):
    """``ivf.build`` runs the port's k-means; from the reference's k-means++
    start it packs the reference's lists."""
    from repro.core import spherical_kmeans as rsk
    case = cases[False]
    key = jax.random.PRNGKey(1)
    init_key, _ = jax.random.split(key)
    start = np.array(rsk.kmeanspp_init(
        init_key, rsk.normalize_rows(case.x), C))
    own = ivf.build(case.ds.database, C, n_iters=6, nprobe=NPROBE,
                    init_centers=start, device="cpu")
    np.testing.assert_array_equal(own.lists.numpy(),
                                  np.asarray(case.kmeans_ivf.lists))
    gen = torch.Generator().manual_seed(0)
    seeded = ivf.build(case.ds.database, C, n_iters=6, generator=gen,
                       device="cpu")
    assert seeded.lists.shape[0] == C
    assert sorted(seeded.lists[seeded.lists >= 0].tolist()) == list(range(N))
    q = torch.from_numpy(case.queries)
    x = torch.from_numpy(case.ds.database)
    got = ivf.search_scorer(q, _port_scorer(case.artifacts("full").scorer),
                            seeded, K, nprobe=C)     # every list: exact
    exact = torch.topk(q @ x.T, K, dim=1)
    assert_topk_close(got, (exact.values, exact.indices), dot_tol(
        _norm(q), _norm(x), D), "nprobe = C")
