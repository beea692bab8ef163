"""The gathered GleanVec path's bucketing, and the shapes above the port's
one-pass limits (k > 128, C > 64), against the JAX reference.

* ``bucket_rows_by_tag_plain``: every row once, each 128-slot tile one
  tag, -1 padding only at a tag's end, rows ascending within a tag; an
  empty tag, a single tag, no rows and out-of-range tags.
* ``gleanvec_sq_topk`` gathered at kappa = 200 (u8 and f32, with a live
  mask) against the Pallas kernel in interpret mode and its ``ref.py``;
  ``kmeans_assign`` at C = 100 likewise; the flat search path of both
  gathered modes at kappa = 200 against the reference's served scan and
  ``state_search``.

Tolerance: both sides add the same fp32 products in different orders
(``testing.dot_tol``); ids may differ only at near-ties of the k-th value
(``assert_topk_close``). The kernels themselves run on the card only
(``cuda`` tests in ``tests/test_torch_port_rules.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gleanvec as rgv
from repro.core import search as rsearch
from repro.data import vectors as rvectors
from repro.index import bruteforce as rbf
from repro.kernels import (gleanvec_sq_topk, gleanvec_sq_topk_ref,
                           kmeans_assign, kmeans_assign_ref)
from repro_torch import convert
from repro_torch import kernels as K
from repro_torch.core import search
from repro_torch.kernels.gleanvec_sq import bucket_tiles
from repro_torch.testing import assert_topk_close, dot_tol


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _norm(a):
    a = np.asarray(a, np.float64)
    return float(np.linalg.norm(a.reshape(-1, a.shape[-1]), axis=1).max())


def _tags(case, rng):
    n, c = case["n"], case["c"]
    if "single" in case:
        return np.full(n, case["single"], np.int32)
    tags = rng.integers(case.get("low", 0), case.get("high", c), n)
    if "empty" in case:
        tags[tags == case["empty"]] = (case["empty"] + 1) % c
    return tags.astype(np.int32)


@pytest.mark.parametrize("case", [
    {"n": 7001, "c": 100, "empty": 7},
    {"n": 5000, "c": 48, "single": 5},
    {"n": 300, "c": 100},
    {"n": 0, "c": 8},
    {"n": 2000, "c": 6, "low": -3, "high": 9},   # clamped to [0, C)
], ids=["c100-empty-tag", "single-tag", "sparse", "no-rows", "clamped"])
def test_bucket_rows_by_tag_plain_layout(case):
    rng = np.random.default_rng(case["n"] + case["c"])
    tags = _tags(case, rng)
    n, c = case["n"], case["c"]
    rows, tile_tags = K.bucket_rows_by_tag(_t(tags), c)   # CPU -> plain
    plain = K.bucket_rows_by_tag_plain(_t(tags), c)
    assert torch.equal(rows, plain[0]) and torch.equal(tile_tags, plain[1])
    rows, tile_tags = rows.numpy(), tile_tags.numpy()
    t = bucket_tiles(n, c)
    assert rows.dtype == np.int32 and tile_tags.dtype == np.int32
    assert rows.shape == (t * 128,) and tile_tags.shape == (t,)
    live = rows[rows >= 0]
    assert np.array_equal(np.sort(live), np.arange(n))    # each row once
    assert (rows >= -1).all()
    clamped = np.clip(tags, 0, c - 1)
    tiles = rows.reshape(t, 128)
    used = 0
    for tag in range(c):
        want = np.nonzero(clamped == tag)[0]                 # ascending
        span = -(-want.size // 128)
        got = tiles[used:used + span]
        assert (tile_tags[used:used + span] == tag).all()    # one tag a tile
        flat = got.reshape(-1)
        assert np.array_equal(flat[:want.size], want)
        assert (flat[want.size:] == -1).all()                # padding at end
        used += span
    assert (tiles[used:] == -1).all() and (tile_tags[used:] == 0).all()
    if "empty" in case:
        assert case["empty"] not in tile_tags[:used]
    if "single" in case:
        assert (tile_tags[:used] == case["single"]).all()
        assert used == -(-n // 128)


@pytest.mark.parametrize("u8", [True, False], ids=["u8", "f32"])
def test_gathered_topk_kappa200_matches_pallas_and_ref(u8):
    """kappa = 200 (two passes of the kernel on the card) with a live mask:
    the plain version against the Pallas kernel and ``ref.py``."""
    m, n, c, d, k = 6, 1500, 8, 16, 200
    rng = np.random.default_rng(200 + u8)
    q_scaled = rng.standard_normal((m, c, d)).astype(np.float32)
    q_lo = rng.standard_normal((m, c)).astype(np.float32)
    codes = (rng.integers(0, 256, (n, d)).astype(np.uint8) if u8
             else rng.standard_normal((n, d)).astype(np.float32))
    tags = rng.integers(0, c, n).astype(np.int32)
    row_ids = np.arange(n, dtype=np.int32)
    row_ids[rng.random(n) < 0.15] = -1
    tol = dot_tol(_norm(q_scaled), _norm(codes), d, float(np.abs(q_lo).max()))
    port = K.gleanvec_sq_topk(_t(q_scaled), _t(q_lo), _t(tags), _t(codes), k,
                              row_ids=_t(row_ids))
    args = (jnp.asarray(q_scaled), jnp.asarray(q_lo), jnp.asarray(tags),
            jnp.asarray(codes), k)
    pallas = gleanvec_sq_topk(*args, row_ids=jnp.asarray(row_ids), tm=2,
                              tn=128, interpret=True)
    ref = gleanvec_sq_topk_ref(*args, row_ids=jnp.asarray(row_ids))
    assert port[0].shape == (m, k) and port[1].dtype == torch.int32
    assert_topk_close(port, pallas, tol, "plain vs pallas")
    assert_topk_close(port, ref, tol, "plain vs ref")
    dropped = set(np.nonzero(row_ids < 0)[0].tolist())
    assert not dropped & set(port[1].numpy().ravel().tolist())


def test_kmeans_assign_c100_matches_pallas_and_ref():
    """C = 100 (two chunks of centers on the card): tags equal, max
    similarities within the fp32 reordering bound."""
    rng = np.random.default_rng(100)
    x = rng.standard_normal((1000, 32)).astype(np.float32)
    cent = rng.standard_normal((100, 32)).astype(np.float32)
    tags, sims = K.kmeans_assign(_t(x), _t(cent))
    tol = dot_tol(_norm(x), _norm(cent), 32)
    for other in (kmeans_assign(jnp.asarray(x), jnp.asarray(cent), tn=256,
                                interpret=True),
                  kmeans_assign_ref(jnp.asarray(x), jnp.asarray(cent))):
        np.testing.assert_array_equal(tags.numpy(), np.asarray(other[0]))
        np.testing.assert_allclose(sims.numpy(), np.asarray(other[1]),
                                   rtol=0, atol=tol)


@pytest.fixture(scope="module")
def gathered_case():
    ds = rvectors.make_dataset("s", n=1024, d=32, n_queries=48, ood=True,
                               seed=5)
    x = jnp.asarray(ds.database)
    model = rgv.fit(jax.random.PRNGKey(0), jnp.asarray(ds.queries_learn), x,
                    c=8, d=8, kmeans_iters=4)
    return ds, x, model


@pytest.mark.parametrize("mode", ["gleanvec", "gleanvec-int8"])
def test_flat_path_kappa200_matches_reference(gathered_case, mode):
    """The gathered modes' flat search at kappa = 200 (the kernel's
    two-pass width on the card): candidates against the reference's served
    scan, final ids against its ``state_search``."""
    ds, x, model = gathered_case
    kappa, k = 200, 10
    ref_art = rsearch.build_artifacts(mode, x, model)
    s = ref_art.scorer
    art = search.SearchArtifacts(
        scorer=convert.scorer(type(s).__name__, convert.arrays_of(s), "cpu"),
        x_full=torch.from_numpy(np.array(ref_art.x_full)),
        model=convert.gleanvec_model(convert.arrays_of(model), "cpu"))
    q_np = ds.queries_test[:16]
    q = torch.from_numpy(q_np)
    state = search.make_state(art)
    qstate = state.index.prepare_queries(art.scorer, q)
    port = state.index.candidates(qstate, art.scorer, kappa)
    served = rbf.scan_scorer(s, s.prepare_queries(jnp.asarray(q_np)), kappa,
                             64)
    qs = qstate.q_scaled if hasattr(qstate, "q_scaled") else qstate
    lo = float(qstate.q_lo.abs().max()) if hasattr(qstate, "q_lo") else 0.0
    rows = art.scorer.codes if hasattr(art.scorer, "codes") \
        else art.scorer.x_low
    tol = dot_tol(_norm(qs.numpy()), _norm(rows.to(torch.float32).numpy()),
                  rows.shape[1], lo)
    assert port[1].shape == (16, kappa)
    assert_topk_close(port, served, tol, f"{mode} vs scan_scorer")
    ids = search.state_search(q, state, k, kappa).numpy()
    ids_ref = np.asarray(rsearch.state_search(
        jnp.asarray(q_np), rsearch.make_state(ref_art), k, kappa))
    xd = ds.database
    safe = np.where(ids >= 0, ids, 0)
    safe_ref = np.where(ids_ref >= 0, ids_ref, 0)
    exact = np.einsum("md,mkd->mk", q_np.astype(np.float64), xd[safe])
    exact_ref = np.einsum("md,mkd->mk", q_np.astype(np.float64),
                          xd[safe_ref])
    full_tol = dot_tol(_norm(q_np), _norm(xd), xd.shape[1])
    assert_topk_close((exact, ids), (exact_ref, ids_ref), full_tol,
                      f"{mode} state_search")


def test_cpu_wide_calls_take_plain_versions():
    """On CPU tensors the widened calls (k = 300, C = 100, a beam of 200,
    the bucketing) run their plain versions and count no launch."""
    counters = (K.ip_topk, K.gleanvec_sq_topk, K.kmeans_assign,
                K.graph_scan_beam_step, K.bucket_rows_by_tag)
    before = [fn.launches for fn in counters]
    vals, ids = K.ip_topk(torch.randn(3, 8), torch.randn(500, 8), 300)
    assert vals.shape == (3, 300) and (ids >= 0).all()
    tags = torch.randint(0, 100, (500,), dtype=torch.int32)
    _, ids = K.gleanvec_sq_topk(torch.randn(3, 100, 8), torch.zeros(3, 100),
                                tags, torch.randn(500, 8), 300)
    assert (ids >= 0).all()
    tags, _ = K.kmeans_assign(torch.randn(50, 8), torch.randn(100, 8))
    assert tags.shape == (50,) and int(tags.max()) < 100
    K.bucket_rows_by_tag(tags, 100)
    n = 640
    beam_v = torch.full((2, 200), -3.4e38)
    beam_i = torch.full((2, 200), -1, dtype=torch.int32)
    v, i = K.graph_scan_beam_step(
        torch.randn(2, 3, 8), torch.zeros(2, 3),
        torch.zeros(n // 64, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32), torch.randn(n, 8),
        torch.stack([torch.randperm(n)[:112] for _ in range(2)]).to(
            torch.int32), beam_v, beam_i,      # 112 distinct live rows a query
        layout_block=64)
    assert v.shape == (2, 200) and (i[:, :100] >= 0).all()
    assert [fn.launches for fn in counters] == before
