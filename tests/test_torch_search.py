"""The port's flat search path against the JAX reference, all 7 modes x
{ID, OOD} queries.

The reference fits and encodes once; ``repro_torch.convert`` carries the
fitted model and the encoded scorer across, so both packages search the
very same codes. Checks per mode:

* ``FlatIndex.candidates`` (the kernel dispatch; on CPU its plain
  versions) against the reference's served scan
  ``bruteforce.scan_scorer`` and its fused kernels
  ``kernels.scorer_topk(interpret=True)``;
* ``state_search`` ids, ``ServingEngine.submit`` (with poisoned rows) and
  recall@10 (within 0.002) against the reference engine.

Tolerance: fp32 products summed in a different order
(``testing.dot_tol``); ids may differ only at near-ties of the k-th
value. Final ids are compared through their exact full-precision scores.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as rkernels
from repro.core import gleanvec as rgv
from repro.core import leanvec_sphering as rlvs
from repro.core import metrics as rmetrics
from repro.core import search as rsearch
from repro.data import vectors as rvectors
from repro.index import bruteforce as rbf
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch import convert
from repro_torch.core import metrics, search
from repro_torch.core.scorer import MODES, QuantQueryState
from repro_torch.serve.engine import ServingEngine
from repro_torch.testing import assert_topk_close, dot_tol

N, D, DR, C, BLOCK, KAPPA, K = 2048, 64, 16, 8, 64, 40, 10


class _Case:
    """One dataset, both reference models, fitted once per query kind."""

    def __init__(self, ood: bool):
        import jax
        self.ds = rvectors.make_dataset("s", n=N, d=D, n_queries=96,
                                        ood=ood, seed=11)
        self.x = jnp.asarray(self.ds.database)
        q = jnp.asarray(self.ds.queries_learn)
        self.models = {
            "sphering": rlvs.fit(q, self.x, DR),
            "gleanvec": rgv.fit(jax.random.PRNGKey(0), q, self.x, c=C, d=DR,
                                kmeans_iters=6),
        }
        self.queries = self.ds.queries_test[:16]


@pytest.fixture(scope="module")
def cases():
    return {False: _Case(False), True: _Case(True)}


def _ref_model(case, mode):
    if mode == "full":
        return None
    return case.models["sphering" if mode.startswith("sphering")
                       else "gleanvec"]


def _port_artifacts(ref_art, mode):
    """The reference artifacts carried across to the port on the CPU."""
    s = ref_art.scorer
    scorer = convert.scorer(type(s).__name__, convert.arrays_of(s), "cpu")
    model = ref_art.model
    if model is not None:
        build = convert.sphering_model if mode.startswith("sphering") \
            else convert.gleanvec_model
        model = build(convert.arrays_of(model), "cpu")
    return search.SearchArtifacts(
        scorer=scorer, x_full=torch.from_numpy(np.array(ref_art.x_full)),
        model=model)


def _leaf_norm(qstate):
    qs = qstate.q_scaled if isinstance(qstate, QuantQueryState) else qstate
    return float(np.linalg.norm(qs.reshape(-1, qs.shape[-1]).numpy(),
                                axis=1).max())


def _exact(queries, x, ids):
    """Full-precision scores of the returned ids (-1 -> NEG_INF)."""
    safe = np.where(ids >= 0, ids, 0)
    s = np.einsum("md,mkd->mk", queries.astype(np.float64), x[safe])
    return np.where(ids >= 0, s, -3.4e38)


@pytest.mark.parametrize("ood", [False, True], ids=["ID", "OOD"])
@pytest.mark.parametrize("mode", MODES)
def test_flat_path_matches_reference(cases, mode, ood):
    case = cases[ood]
    ref_art = rsearch.build_artifacts(mode, case.x, _ref_model(case, mode))
    if mode.endswith("sorted"):      # the test size wants a small block
        from repro.core import scorer as rsc
        ref_art = ref_art._replace(scorer=rsc.build_scorer(
            mode, case.x, ref_art.model, block=BLOCK))
    art = _port_artifacts(ref_art, mode)
    kappa = K if mode == "full" else KAPPA
    q_np = case.queries
    q = torch.from_numpy(q_np)

    # main search: the port's FlatIndex vs the reference's scan and kernels
    state = search.make_state(art)
    qstate = state.index.prepare_queries(art.scorer, q)
    port = state.index.candidates(qstate, art.scorer, kappa)
    leaves = qstate if isinstance(qstate, QuantQueryState) else (qstate,)
    assert all(t.is_contiguous() for t in leaves)   # the kernels need it
    ref_q = ref_art.scorer.prepare_queries(jnp.asarray(q_np))
    served = rbf.scan_scorer(ref_art.scorer, ref_q, kappa, 64)
    fused = rkernels.scorer_topk(ref_art.scorer, jnp.asarray(q_np), kappa,
                                 interpret=True)
    rows = art.scorer.x_low if hasattr(art.scorer, "x_low") \
        else art.scorer.codes
    lo = np.abs(qstate.q_lo.numpy()).max() \
        if isinstance(qstate, QuantQueryState) else 0.0
    tol = dot_tol(_leaf_norm(qstate), float(np.linalg.norm(
        rows.to(torch.float32).numpy(), axis=1).max()), rows.shape[1], lo)
    assert_topk_close(port, served, tol, f"{mode} vs scan_scorer")
    assert_topk_close(port, fused, tol, f"{mode} vs scorer_topk")

    # Algorithm 1 end to end: same final ids up to near-ties
    ids = search.state_search(q, state, K, kappa).numpy()
    ids_ref = np.asarray(rsearch.state_search(
        jnp.asarray(q_np), rsearch.make_state(ref_art), K, kappa))
    x = case.ds.database
    full_tol = dot_tol(float(np.linalg.norm(q_np, axis=1).max()),
                       float(np.linalg.norm(x, axis=1).max()), D)
    assert_topk_close((_exact(q_np, x, ids), ids),
                      (_exact(q_np, x, ids_ref), ids_ref), full_tol,
                      f"{mode} state_search")

    # the serving engines, with two poisoned rows and a ragged tail batch
    poisoned = q_np.copy()
    poisoned[3, 5] = np.nan
    poisoned[7, 0] = np.inf
    eng = ServingEngine(search.make_state(art), k=K, kappa=kappa,
                        batch_size=6, dim=D)
    ref_eng = RefEngine(rsearch.make_state(ref_art), k=K, kappa=kappa,
                        batch_size=6, dim=D)
    got, want = eng.submit(poisoned), np.asarray(ref_eng.submit(poisoned))
    assert got.dtype == np.int32 and got.shape == (16, K)
    assert (got[[3, 7]] == -1).all() and (want[[3, 7]] == -1).all()
    assert eng.stats.n_sanitized == 2 and eng.stats.n_batches == 3
    ok = np.ones(16, bool)
    ok[[3, 7]] = False
    assert_topk_close((_exact(q_np[ok], x, got[ok]), got[ok]),
                      (_exact(q_np[ok], x, want[ok]), want[ok]), full_tol,
                      f"{mode} engine")

    rec = metrics.recall_at_k(ids, case.ds.gt[:16, :K])
    rec_ref = float(rmetrics.recall_at_k(jnp.asarray(ids_ref),
                                         jnp.asarray(case.ds.gt[:16, :K])))
    assert abs(rec - rec_ref) <= 0.002


def test_rerank_minus_one_never_wins():
    """-1 candidate slots lose to every real id, even at equal scores, and
    pad a short candidate list's tail."""
    x = torch.zeros(5, 4)
    art = search.SearchArtifacts(scorer=None, x_full=x)
    cand = torch.tensor([[-1, 2, -1, 4, 1], [-1, -1, -1, 3, -1]],
                        dtype=torch.int32)
    out = search.rerank(torch.ones(2, 4), art, cand, 3)
    assert out[0].tolist() == [2, 4, 1]          # all real ids score 0
    assert out[1].tolist() == [3, -1, -1]


def test_engine_swap_checks_shapes(cases):
    case = cases[True]
    ref_art = rsearch.build_artifacts("sphering-int8", case.x,
                                      case.models["sphering"])
    art = _port_artifacts(ref_art, "sphering-int8")
    eng = ServingEngine(search.make_state(art), k=K, kappa=KAPPA,
                        batch_size=8, dim=D)
    codes = art.scorer.codes.clone()
    codes[0] = 255 - codes[0]
    eng.swap(search.make_state(art._replace(
        scorer=art.scorer._replace(codes=codes))))
    assert eng.version == 1 and eng.n_swaps == 1
    with pytest.raises(ValueError, match="swap would change"):
        eng.swap(search.make_state(art._replace(
            scorer=art.scorer._replace(codes=codes[:-1]))))
    with pytest.raises(ValueError, match="swap would change"):
        eng.swap(search.make_state(art._replace(
            scorer=art.scorer._replace(codes=codes.to(torch.float32)))))
    assert eng.version == 1
    assert eng.submit(np.zeros((0, D), np.float32)).shape == (0, K)
    with pytest.raises(ValueError):
        eng.submit(np.zeros((3, D + 1), np.float32))


def test_port_builds_every_mode_itself(cases):
    """The port's own encode path (build_artifacts on its own fitted
    models) serves every mode with recall close to the reference's."""
    from repro_torch.core import gleanvec as gv
    from repro_torch.core import leanvec_sphering as lvs
    case = cases[False]
    x = torch.from_numpy(case.ds.database)
    sph = lvs.fit(case.ds.queries_learn, x, DR, device="cpu")
    glv = gv.fit(case.ds.queries_learn, x, c=C, d=DR, kmeans_iters=6,
                 generator=torch.Generator().manual_seed(0), device="cpu")
    q = torch.from_numpy(case.queries)
    for mode in MODES:
        model = None if mode == "full" else (
            sph if mode.startswith("sphering") else glv)
        art = search.build_artifacts(mode, x, model, block=BLOCK,
                                     device="cpu")
        kappa = K if mode == "full" else KAPPA
        ids = search.state_search(q, search.make_state(art), K, kappa)
        rec = metrics.recall_at_k(ids, case.ds.gt[:16, :K])
        assert rec >= 0.9, (mode, rec)


def test_full_rotation_rerank_and_two_stage_path(cases):
    """Section 3.1: a d == D sphering model stores x' = B'x as the rerank
    store and rotates queries by A' (``rerank_a``); the flat path then
    ranks like exact search. ``state_candidates`` is the main search
    alone, ``scorer_topk`` the unprepared lowering."""
    from repro_torch import kernels
    from repro_torch.core import leanvec_sphering as lvs
    case = cases[False]
    x = torch.from_numpy(case.ds.database)
    q = torch.from_numpy(case.queries)
    rng = np.random.default_rng(0)
    learn = rng.standard_normal((256, D)).astype(np.float32)
    model = lvs.full_rotation_model(learn, x, device="cpu")
    art = search.build_artifacts_sphering(model, x, device="cpu")
    assert art.rerank_a is not None and art.x_full.shape == (N, D)
    state = search.make_state(art)
    ids = search.state_search(q, state, K, KAPPA).numpy()
    exact = search.state_search(
        q, search.make_state(search.build_artifacts("full", x, device="cpu")),
        K, K).numpy()
    full_tol = 4 * dot_tol(float(q.norm(dim=1).max()),
                           float(x.norm(dim=1).max()), D)
    qn = case.queries
    assert_topk_close((_exact(qn, case.ds.database, ids), ids),
                      (_exact(qn, case.ds.database, exact), exact), full_tol,
                      "full rotation")
    cand = search.state_candidates(q, state, KAPPA)
    assert cand.shape == (16, KAPPA)
    assert set(ids[0].tolist()) <= set(cand[0].tolist())
    _, i1 = kernels.scorer_topk(art.scorer, q, KAPPA)
    assert torch.equal(i1, cand)
    glv = search.build_artifacts_gleanvec(
        convert.gleanvec_model(convert.arrays_of(case.models["gleanvec"]),
                               "cpu"), x, device="cpu")
    assert glv.scorer.tags.shape == (N,) and glv.rerank_a is None
