"""The pipelined fp32 scans: ``ip_topk`` (``csrc/ip_scan.cuh``) and
``kmeans_assign`` (centers streamed with the rows).

On the CPU:

* ``ip_topk.scan_plan``, the wrapper's grid and partial-list sizing, for
  any M, N and k (k > 128 too): one wave of blocks, S (splits of the row
  tiles) at most the row tiles, S * pass_k(k) at most ``MERGE_MAX``, and
  every size follows the pipelined scan's tile (``IP_TILE_M`` /
  ``IP_TILE_N``, the constants of ``ip_scan.cuh``), not ``scan_gemm.cuh``'s
  ``GEMM_TILE_*``;
* the graph build's self-join pads rows and queries with zero columns to a
  multiple of 4 (d = 33: 34 -> 36): its ids equal the unpadded join's, and
  its lists agree with the reference's ``_device_knn`` on the same numpy
  rows within ``testing.dot_tol`` (ids may differ only at near-ties of the
  k-th value).

On the card (``cuda`` marker, skipped elsewhere; no JAX import at module
level, so ``python -m pytest -m cuda tests/test_torch_fp32_scans.py`` runs
on a machine without it):

* ``ip_topk`` at d in {1, 3, 160, 512, 513, 516}, M in {1, 1000, 1024},
  ragged N, k in {1, 10, 49, 100, 200}, f32 and u8 rows, on small-integer
  data, so that every score is exact in fp32 whatever the order of its
  sum: vals and ids equal the exact top-k (value descending, ties to the
  smaller id) bit for bit, and agree with the plain version;
* two identical calls give bit-identical outputs;
* ``kmeans_assign`` at C in {1, 7, 48, 100, 129, 300} and D in {3, 512,
  513, 7000} on integer data: tags are the first maximum and maxsim the
  exact maximum; on random data it agrees with its plain version within
  ``testing.dot_tol``; a tie across two center tiles goes to the first
  center;
* the recommenders' retrieval widths (D = 10, 32, 64: FM, BST, MIND;
  d = 16, C = 16) at batch 1 and 512: ``ip_topk`` over the D-wide rows
  (FM's 40-byte rows are off 16-byte alignment), ``kmeans_assign`` at C
  16, and ``gleanvec_sq_topk`` gathered and sorted, f32 and u8, all bit
  for bit on integer data against the exact top-k and the plain versions;
* one scan past 2^31 elements (4.2M x 512 rows, the 64-bit row offsets
  of OI-13M): ``ip_topk``, ``kmeans_assign`` and the gathered
  ``gleanvec_sq_topk`` over u8 codes, equal to their plain versions on
  integer data, with winners planted past row 2^31 / 512.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.ip_topk import scan_plan
from repro_torch.testing import assert_topk_close, dot_tol

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


# ---------------------------------------------------------------------------
# CPU: the wrapper's sizing.
# ---------------------------------------------------------------------------


def _cuh_constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / "ip_scan.cuh").read_text())
    assert m, f"{name} not found in ip_scan.cuh"
    return int(m.group(1))


def test_tile_constants_match_the_kernel_source():
    """The wrapper sizes its buffers by the kernel's own tile."""
    assert (K.IP_TILE_M, K.IP_TILE_N) == (_cuh_constant("IP_TM"),
                                          _cuh_constant("IP_TN"))


@pytest.mark.parametrize("m,n,k", [
    (1, 1, 1), (1, 2_000_000, 10), (1000, 3001, 49), (1024, 2_000_000, 100),
    (1024, 1_000_000, 49), (37, 5003, 200), (70, 20011, 1000),
    (1024, 256, 129), (5000, 7, 128), (64, 0, 10), (100_000, 50_000, 10)])
@pytest.mark.parametrize("sms", [1, 132])
def test_ip_topk_scan_plan(m, n, k, sms):
    plan = scan_plan(m, n, k, sms)
    row_tiles = -(-n // K.IP_TILE_N)
    query_blocks = -(-m // K.IP_TILE_M)
    assert plan.grid == (query_blocks, plan.splits)
    assert 1 <= plan.splits <= max(1, row_tiles)
    assert plan.splits * K.pass_k(k) <= K.MERGE_MAX
    assert plan.partial_shape == (m, plan.splits, min(k, K.PASS_K))
    # one wave of blocks (one an SM), unless the queries alone need more
    if query_blocks <= sms:
        assert query_blocks * plan.splits <= sms
    else:
        assert plan.splits == 1


def test_ip_topk_scan_plan_follows_its_own_tile(monkeypatch):
    """A change of scan_gemm.cuh's tile leaves the plan alone; the
    pipelined scan's tile moves it."""
    base = scan_plan(1024, 2_000_000, 10, 132)
    assert base == ((16, 8), 8, (1024, 8, 10))
    monkeypatch.setattr(K, "GEMM_TILE_M", 7)
    monkeypatch.setattr(K, "GEMM_TILE_N", 3)
    assert scan_plan(1024, 2_000_000, 10, 132) == base
    monkeypatch.setattr(K, "IP_TILE_M", 32)
    assert scan_plan(1024, 2_000_000, 10, 132).grid == (32, 4)
    monkeypatch.setattr(K, "IP_TILE_N", 1 << 20)
    assert scan_plan(1024, 2_000_000, 10, 132).splits == 2


# ---------------------------------------------------------------------------
# CPU: the padded self-join.
# ---------------------------------------------------------------------------


def _unpadded_knn(x, k, batch):
    """The self-join as it was before padding: rows [x, -|x|^2 / 2] and
    queries [q, 1], d + 1 wide."""
    from repro_torch.core.scorer import LinearScorer
    n = x.shape[0]
    xsq = torch.sum(x * x, dim=1)
    scorer = LinearScorer(x_low=torch.cat([x, -0.5 * xsq[:, None]], dim=1))
    out = torch.empty((n, k), dtype=torch.int64)
    for s in range(0, n, batch):
        e = min(s + batch, n)
        q = torch.cat([x[s:e], torch.ones((e - s, 1))], dim=1)
        _, ids = K.scorer_topk(scorer, q, k + 1)
        keep = ids != torch.arange(s, e)[:, None]
        sel = torch.sort((~keep).to(torch.int8), dim=1,
                         stable=True).indices[:, :k]
        out[s:e] = torch.gather(ids, 1, sel).to(torch.int64)
    return out


@pytest.fixture(scope="module")
def knn_rows():
    rng = np.random.default_rng(17)
    centers = rng.normal(size=(12, 33)).astype(np.float32) * 3
    x = centers[rng.integers(0, 12, 2000)] \
        + rng.normal(size=(2000, 33)).astype(np.float32)
    return x.astype(np.float32)


def test_padded_self_join_equals_unpadded(knn_rows):
    from repro_torch.index import graph
    x = torch.as_tensor(knn_rows)
    got = graph._device_knn(x, 16, batch=300)
    want = _unpadded_knn(x, 16, batch=300)
    assert got.shape == (2000, 16) and got.dtype == torch.int64
    assert torch.equal(got, want)


def test_padded_self_join_matches_reference(knn_rows):
    """Against the reference's self-join on the same rows: top-k sets of
    the augmented inner product, scored here in float64, within dot_tol
    of the (d + 1)-wide products."""
    from repro.index import graph as rgraph

    from repro_torch.index import graph
    x = knn_rows
    got = graph._device_knn(torch.as_tensor(x), 16, batch=300).numpy()
    want = rgraph._device_knn(x, 16, batch=300)
    x64 = x.astype(np.float64)
    aug = np.concatenate([x64, -0.5 * np.sum(x64 * x64, 1, keepdims=True)],
                         1)
    q = np.concatenate([x64, np.ones((x.shape[0], 1))], 1)

    def scored(ids):
        return np.einsum("nkd,nd->nk", aug[ids], q), ids

    tol = dot_tol(float(np.linalg.norm(q, axis=1).max()),
                  float(np.linalg.norm(aug, axis=1).max()), aug.shape[1])
    assert_topk_close(scored(got), scored(want), tol, "padded self-join")


# ---------------------------------------------------------------------------
# The card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _exact_topk(q, x, k):
    """Top-k of exact scores (integer data: float64 products are exact),
    value descending, ties to the smaller id; (NEG_INF, -1) past N."""
    s = q.double() @ x.double().T
    vals, order = torch.sort(s, dim=1, descending=True, stable=True)
    kk = min(k, x.shape[0])
    v = torch.full((q.shape[0], k), K.NEG_INF, dtype=torch.float32,
                   device=q.device)
    i = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=q.device)
    v[:, :kk] = vals[:, :kk].float()
    i[:, :kk] = order[:, :kk].int()
    return v, i


@pytest.mark.cuda
@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("d", [1, 3, 160, 512, 513, 516])
def test_cuda_ip_topk_exact_on_integer_data(cuda, d, u8):
    g = torch.Generator(device=cuda).manual_seed(d)
    for m, n in ((1, 3001), (1000, 2999), (1024, 4097)):
        q = torch.randint(-3, 4, (m, d), generator=g, device=cuda).float()
        if u8:
            x = torch.randint(0, 4, (n, d), generator=g, device=cuda,
                              dtype=torch.uint8)
        else:
            x = torch.randint(-3, 4, (n, d), generator=g,
                              device=cuda).float()
        for k in (1, 10, 49, 100, 200):
            got = K.ip_topk(q, x, k)
            want = _exact_topk(q, x, k)
            label = f"d={d} {'u8' if u8 else 'f32'} M={m} N={n} k={k}"
            assert torch.equal(got[0], want[0]), label
            assert torch.equal(got[1], want[1]), label
            assert_topk_close(got, K.ip_topk_plain(q, x, k), 0.0, label)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 160, 513])
def test_cuda_ip_topk_random_data_and_k_above_n(cuda, d):
    """Random floats against the plain version (fp32 sums in another
    order: dot_tol), unaligned row starts (a view one row in), and
    k above N ((NEG_INF, -1) filling)."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(1000, d, generator=g, device=cuda)
    x = torch.randn(7001, d, generator=g, device=cuda)
    tol = dot_tol(float(q.norm(dim=1).max()), float(x.norm(dim=1).max()), d)
    for k in (10, 100, 200):
        assert_topk_close(K.ip_topk(q, x, k), K.ip_topk_plain(q, x, k), tol,
                          f"d={d} k={k}")
    xs = x[1:]                          # d * 4 bytes off 16-byte alignment
    assert_topk_close(K.ip_topk(q, xs, 49), K.ip_topk_plain(q, xs, 49), tol,
                      f"d={d} shifted rows")
    small = x[:37]
    vals, ids = K.ip_topk(q, small, 50)
    assert bool((ids[:, 37:] == -1).all())
    assert bool((vals[:, 37:] == K.NEG_INF).all())
    assert_topk_close((vals, ids), K.ip_topk_plain(q, small, 50), tol,
                      f"d={d} k above N")


@pytest.mark.cuda
def test_cuda_ip_topk_ties_go_to_the_smaller_id(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    for u8 in (False, True):
        row = (torch.randint(0, 256, (1, 160), generator=g, device=cuda,
                             dtype=torch.uint8) if u8 else
               torch.randn(1, 160, generator=g, device=cuda))
        x = row.expand(5000, 160).contiguous()
        q = torch.randn(70, 160, generator=g, device=cuda)
        for k in (49, 200):
            _, ids = K.ip_topk(q, x, k)
            want = torch.arange(k, dtype=torch.int32, device=cuda)
            assert torch.equal(ids, want.expand(70, -1)), (u8, k)


@pytest.mark.cuda
def test_cuda_ip_topk_is_deterministic(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    for d, k, u8 in ((160, 100, False), (160, 100, True), (516, 49, False),
                     (512, 10, False)):
        q = torch.randn(1024, d, generator=g, device=cuda)
        x = (torch.randint(0, 256, (50000, d), generator=g, device=cuda,
                           dtype=torch.uint8) if u8 else
             torch.randn(50000, d, generator=g, device=cuda))
        a, b = K.ip_topk(q, x, k), K.ip_topk(q, x, k)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _first_max(x, cent):
    s = x.double() @ cent.double().T
    best = s.max(dim=1).values
    return torch.argmax((s == best[:, None]).int(), dim=1).int(), best.float()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 7, 48, 100, 129, 300])
@pytest.mark.parametrize("d", [3, 512, 513, 7000])
def test_cuda_kmeans_assign_any_c_and_d(cuda, c, d):
    g = torch.Generator(device=cuda).manual_seed(c * 10007 + d)
    n = 3001
    x = torch.randint(-2, 3, (n, d), generator=g, device=cuda).float()
    cent = torch.randint(-2, 3, (c, d), generator=g, device=cuda).float()
    tags, sims = K.kmeans_assign(x, cent)
    want_tags, want_sims = _first_max(x, cent)
    assert torch.equal(tags, want_tags) and torch.equal(sims, want_sims)
    x = torch.randn(n, d, generator=g, device=cuda)
    cent = torch.randn(c, d, generator=g, device=cuda)
    tags, sims = K.kmeans_assign(x, cent)
    want_tags, want_sims = K.kmeans_assign_plain(x, cent)
    tol = dot_tol(float(x.norm(dim=1).max()), float(cent.norm(dim=1).max()),
                  d)
    assert float((sims - want_sims).abs().max()) <= tol
    diff = tags != want_tags                        # near-ties only
    alt = (x[diff] * cent[tags[diff].long()]).sum(dim=1)
    assert float((want_sims[diff] - alt).abs().sum()) <= tol * alt.numel()


@pytest.mark.cuda
def test_cuda_kmeans_assign_tie_across_center_tiles(cuda):
    """C = 300 runs three center tiles of 100 (tiles of 104 slots): center
    250 equals center 3, and every row equal to it goes to center 3."""
    g = torch.Generator(device=cuda).manual_seed(0)
    cent = torch.nn.functional.normalize(
        torch.randn(300, 64, generator=g, device=cuda), dim=1)
    cent[250] = cent[3]
    cent[120] = cent[3]
    x = cent[3].expand(777, 64).contiguous() + 0.0
    tags, sims = K.kmeans_assign(x, cent)
    assert bool((tags == 3).all()) and bool((sims == sims[0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [10, 32, 64])
def test_cuda_scans_at_retrieval_widths_and_batch_one(cuda, dim):
    g = torch.Generator(device=cuda).manual_seed(dim)
    n, c, d, lb = 10_001, 16, 16, 64
    x = torch.randint(-3, 4, (n, dim), generator=g, device=cuda).float()
    cent = torch.randint(-2, 3, (c, dim), generator=g, device=cuda).float()
    tags, sims = K.kmeans_assign(x, cent)
    want_tags, want_sims = _first_max(x, cent)
    assert torch.equal(tags, want_tags) and torch.equal(sims, want_sims)
    low = torch.randint(-3, 4, (n, d), generator=g, device=cuda).float()
    codes = torch.randint(0, 8, (n, d), generator=g, device=cuda,
                          dtype=torch.uint8)
    nb = -(-n // lb)
    block_tags = torch.randint(0, c, (nb,), generator=g, device=cuda,
                               dtype=torch.int32)
    pad = nb * lb - n
    for m in (1, 512):
        q = torch.randint(-3, 4, (m, dim), generator=g, device=cuda).float()
        for k in (10, 100):
            got = K.ip_topk(q, x, k)
            want = _exact_topk(q, x, k)
            label = f"ip_topk D={dim} M={m} k={k}"
            assert torch.equal(got[0], want[0]), label
            assert torch.equal(got[1], want[1]), label
        qs = torch.randint(-3, 4, (m, c, d), generator=g,
                           device=cuda).float()
        qlo = torch.randint(-8, 9, (m, c), generator=g, device=cuda).float()
        for rows in (low, codes):
            label = f"gleanvec_sq_topk {rows.dtype} M={m}"
            assert_topk_close(K.gleanvec_sq_topk(qs, qlo, tags, rows, 100),
                              K.gleanvec_sq_topk_plain(qs, qlo, tags, rows,
                                                       100), 0.0,
                              label + " gathered")
            srt = torch.cat([rows, rows[:pad]]) if pad else rows
            rid = torch.arange(srt.shape[0], dtype=torch.int32, device=cuda)
            rid[n:] = -1
            assert_topk_close(
                K.gleanvec_sq_topk(qs, qlo, block_tags, srt, 100,
                                   row_ids=rid, layout_block=lb),
                K.gleanvec_sq_topk_plain(qs, qlo, block_tags, srt, 100,
                                         row_ids=rid, layout_block=lb),
                0.0, label + " sorted")


@pytest.mark.cuda
def test_cuda_scans_past_two_to_the_31_elements(cuda):
    """4.2M x 512 rows hold 2.15e9 elements: every row offset past row
    2^31 / 512 = 4,194,304 needs 64 bits. Integer data, so the plain
    versions are exact; the best rows are planted past that row."""
    g = torch.Generator(device=cuda).manual_seed(31)
    n, dim, edge = 4_200_000, 512, (1 << 31) // 512
    x = torch.randint(-1, 2, (n, dim), generator=g, device=cuda,
                      dtype=torch.int8).float()
    q = torch.randint(1, 3, (8, dim), generator=g, device=cuda).float()
    x[edge + 1000:edge + 1010] = 3.0            # the winners
    got = K.ip_topk(q, x, 10)
    assert_topk_close(got, K.ip_topk_plain(q, x, 10), 0.0, "ip_topk")
    assert bool((got[1] >= edge).all())
    cent = torch.randint(-2, 3, (7, dim), generator=g, device=cuda).float()
    cent[5] = 3.0
    tags, sims = K.kmeans_assign(x, cent)
    want_tags, want_sims = K.kmeans_assign_plain(x, cent)
    assert torch.equal(tags, want_tags) and torch.equal(sims, want_sims)
    assert bool((tags[edge + 1000:edge + 1010] == 5).all())
    codes = (x + 1).to(torch.uint8)
    del x
    qs = torch.randint(0, 3, (8, 7, dim), generator=g, device=cuda).float()
    qlo = torch.zeros(8, 7, device=cuda)
    got = K.gleanvec_sq_topk(qs, qlo, tags, codes, 10)
    assert_topk_close(got, K.gleanvec_sq_topk_plain(qs, qlo, tags, codes,
                                                    10), 0.0,
                      "gleanvec_sq_topk u8 gathered")
    assert bool((got[1] >= edge).any())
