"""The sorted ``gleanvec_sq_topk`` and ``sq_dot`` on the pipelined fp32 scan
(``csrc/ip_scan.cuh``: views per layout block, and the dense-store
instantiation).

On the CPU:

* the launch shapes, for any M, N, k (k > 128 too) and layout block L
  (1, 64, 200, 256, 4096), N = 0 and 1: ``gleanvec_sq.sorted_scan_plan``
  (one wave of one block an SM, S at most the tiles, S * pass_k(k) at most
  ``MERGE_MAX``; with one view a tile the tiles are cut at layout-block
  ends, with two they are the plain 512-row tiles) and ``sq_dot.dense_plan``
  (one wave, no partial lists), and ``gleanvec_sq.sorted_dense_plan`` (the
  sorted dense scores: one wave over the sorted tiles, no partial lists;
  two views a tile at the stream's L = 256 and at 768);
* the plans' tile against the kernel sources: ``IP_TM`` / ``IP_TN`` of
  ``ip_scan.cuh``, the tile that ``gleanvec_sq.cu`` and ``dense_scores.cu``
  report at bind time, and the shared memory of one view a tile at every
  pass length (so every L is served) and of two views where the library
  takes them;
* the sorted top-k at the stream's L = 256, and at kappa = 200, and
  ``sq_dot`` at M and N off the new tiles, against the JAX reference's
  Pallas kernels in interpret mode and their ``ref.py``, from numpy inputs
  made from a seed; tolerance ``testing.dot_tol`` (fp32 sums in another
  order).

On the card (``cuda`` marker, skipped elsewhere; JAX is imported inside the
CPU tests only, so ``python -m pytest -m cuda
tests/test_torch_sorted_scans.py`` runs on a machine without it):

* the sorted top-k on small-integer data (every score exact in fp32 in any
  order) equals the exact top-k (value descending, ties to the smaller
  id, padding rows never listed) bit for bit, at L in {1, 64, 200, 256,
  512, 4096}, f32 and u8 codes, row_ids with -1, k in {1, 10, 100, 200},
  ragged M and N; a tie across layout blocks of different tags;
* ``sq_dot`` bit for bit against its plain version on integer data at d in
  {1, 3, 160, 513}, u8 rows off 4-byte alignment, ragged M and N;
* the sorted dense ``gleanvec_sq`` bit for bit against its plain version
  on integer data at L in {1, 64, 200, 256, 768, 4096} (one view a tile
  off the 512-row tile, two at 256 and 768), f32 and u8, ragged last
  blocks;
* two identical calls give bit-identical outputs;
* with the plain versions monkeypatched to raise, both wrappers launch
  their kernel on CUDA tensors.
"""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.gleanvec_sq import (sorted_dense_plan,
                                             sorted_scan_plan, sorted_tiles)
from repro_torch.kernels.sq_dot import dense_plan
from repro_torch.testing import (assert_topk_close, dot_tol,
                                 exact_sorted_topk)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
LAYOUT_BLOCKS = (1, 64, 200, 256, 4096)


# ---------------------------------------------------------------------------
# CPU: launch shapes.
# ---------------------------------------------------------------------------


def _views(layout_block):
    """Views a tile where two could serve (the library also checks shared
    memory: tests below)."""
    lb = layout_block
    return 2 if lb % K.IP_TILE_N and lb % (K.IP_TILE_N // 2) == 0 else 1


def _tile_rows(n, lb, views):
    """Python enumeration of the sorted scan's tiles: (first row, end row,
    layout block of each view group)."""
    tn = K.IP_TILE_N
    out = []
    if views == 2:
        for r0 in range(0, n, tn):
            out.append((r0, min(r0 + tn, n),
                        tuple(min(r // lb, -(-n // lb) - 1)
                              for r in (r0, r0 + tn // 2))))
        return out
    for seg in range(-(-n // lb)):
        for sub in range(-(-lb // tn)):
            r0 = min(seg * lb + sub * tn, n)
            out.append((r0, min(r0 + tn, seg * lb + lb, n), (seg,)))
    return out


@pytest.mark.parametrize("lb", LAYOUT_BLOCKS)
@pytest.mark.parametrize("n", [0, 1, 255, 256, 3001, 8192])
def test_sorted_tiles_cover_each_layout_block_once(n, lb):
    """Every row lies in exactly one tile, and each view group of a tile
    lies inside one layout block (the rows a view multiplies)."""
    views = _views(lb)
    tiles = _tile_rows(n, lb, views)
    assert len(tiles) == sorted_tiles(n, lb, views)
    seen = np.zeros(n, np.int64)
    for r0, r1, segs in tiles:
        assert r1 - r0 <= K.IP_TILE_N
        seen[r0:r1] += 1
        width = K.IP_TILE_N // views
        for v, seg in enumerate(segs):
            rows = np.arange(r0 + v * width, min(r0 + (v + 1) * width, r1))
            assert (rows // lb == seg).all()
    assert (seen == 1).all()


@pytest.mark.parametrize("lb", LAYOUT_BLOCKS)
@pytest.mark.parametrize("m,n,k", [
    (1, 0, 10), (1, 1, 1), (37, 5003, 100), (1024, 2_000_000, 100),
    (1024, 2_000_256, 200), (1000, 3001, 129), (5000, 7, 128),
    (70, 20011, 1000)])
@pytest.mark.parametrize("sms", [1, 132])
def test_sorted_scan_plan(m, n, k, lb, sms):
    views = _views(lb)
    plan = sorted_scan_plan(m, n, k, lb, views, sms)
    tiles = sorted_tiles(n, lb, views)
    query_blocks = -(-m // K.IP_TILE_M)
    assert plan.grid == (query_blocks, plan.splits)
    assert 1 <= plan.splits <= max(1, tiles)
    assert plan.splits * K.pass_k(k) <= K.MERGE_MAX
    assert plan.partial_shape == (m, plan.splits, min(k, K.PASS_K))
    if query_blocks <= sms:                  # one wave, one block an SM
        assert query_blocks * plan.splits <= sms
    else:
        assert plan.splits == 1
    # one view a tile whatever the layout block: the tiles cut at its end
    one = sorted_tiles(n, lb, 1)
    assert one == -(-n // lb) * -(-lb // K.IP_TILE_N)
    assert one >= -(-n // K.IP_TILE_N)


def test_sorted_scan_plan_main_path_shapes():
    """The flat main path (L = 4096) and the stream's sorted stores (L =
    256, two views) at M = 1024 on 132 SMs: 16 query blocks x 8 splits,
    and 512-row tiles in both (no tile is cut)."""
    n = 489 * 4096                       # sorted rows, padded to L = 4096
    assert sorted_scan_plan(1024, n, 100, 4096, 1, 132) == \
        ((16, 8), 8, (1024, 8, 100))
    assert sorted_scan_plan(1024, n, 100, 256, 2, 132) == \
        ((16, 8), 8, (1024, 8, 100))
    assert sorted_tiles(n, 4096, 1) == sorted_tiles(n, 256, 2) \
        == -(-n // 512)
    assert sorted_tiles(n, 256, 1) == 2 * (n // 512)   # one view: half wasted
    with pytest.raises(ValueError):
        sorted_scan_plan(1024, n, 100, 256, 3, 132)


@pytest.mark.parametrize("m,n", [(0, 5), (1, 1), (1, 2_000_000),
                                 (1024, 2_000_000), (1030, 513), (65, 511),
                                 (100_000, 5000), (3, 0)])
@pytest.mark.parametrize("sms", [1, 132])
def test_sq_dot_dense_plan(m, n, sms):
    plan = dense_plan(m, n, sms)
    tiles = -(-n // K.IP_TILE_N)
    query_blocks = -(-m // K.IP_TILE_M)
    assert plan.grid == (query_blocks, plan.splits)
    assert plan.partial_shape is None
    assert 1 <= plan.splits <= max(1, tiles)
    if 0 < query_blocks <= sms:
        assert query_blocks * plan.splits <= sms


@pytest.mark.parametrize("lb", LAYOUT_BLOCKS + (768,))
@pytest.mark.parametrize("m,n", [(0, 5), (1, 1), (1030, 513), (65, 20011),
                                 (1024, 2_000_256), (100_000, 5000)])
@pytest.mark.parametrize("sms", [1, 132])
def test_sorted_dense_plan(m, n, lb, sms):
    views = _views(lb)
    plan = sorted_dense_plan(m, n, lb, views, sms)
    tiles = sorted_tiles(n, lb, views)
    query_blocks = -(-m // K.IP_TILE_M)
    assert plan.grid == (query_blocks, plan.splits)
    assert plan.partial_shape is None
    assert 1 <= plan.splits <= max(1, tiles)
    if 0 < query_blocks <= sms:
        assert query_blocks * plan.splits <= sms


def test_sorted_dense_plan_stream_shape():
    """The stream's final sorted stores (L = 256, two views a tile) at
    M = 1024 on 132 SMs: 16 query blocks x 8 splits of the plain 512-row
    tiles, as ``sq_dot``'s plan on the same rows; one view would cut every
    tile in half."""
    n = 9383 * 256
    assert sorted_dense_plan(1024, n, 256, 2, 132) == dense_plan(1024, n, 132)
    assert sorted_dense_plan(1024, n, 256, 2, 132).grid == (16, 8)
    assert sorted_tiles(n, 256, 1) == n // 256 == 9383
    assert sorted_tiles(n, 256, 2) == -(-n // 512) == 4692
    with pytest.raises(ValueError):
        sorted_dense_plan(1024, n, 256, 0, 132)


def test_plans_follow_the_pipelined_tile(monkeypatch):
    """The new plans move with the pipelined scan's tile, not with
    scan_gemm.cuh's."""
    base = (dense_plan(1024, 2_000_000, 132),
            sorted_scan_plan(1024, 2_000_000, 100, 4096, 1, 132))
    assert base[0] == ((16, 8), 8, None)
    monkeypatch.setattr(K, "GEMM_TILE_M", 7)
    monkeypatch.setattr(K, "GEMM_TILE_N", 3)
    assert (dense_plan(1024, 2_000_000, 132),
            sorted_scan_plan(1024, 2_000_000, 100, 4096, 1, 132)) == base
    monkeypatch.setattr(K, "IP_TILE_M", 32)
    assert dense_plan(1024, 2_000_000, 132).grid == (32, 4)
    assert sorted_scan_plan(1024, 2_000_000, 100, 4096, 1, 132).grid \
        == (32, 4)


# ---------------------------------------------------------------------------
# CPU: the plans' tile against the kernel sources.
# ---------------------------------------------------------------------------


def _constant(name, text):
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, f"{name} not found"
    return int(m.group(1))


def test_tile_constants_match_the_kernel_sources():
    scan = (CSRC / "ip_scan.cuh").read_text()
    assert (K.IP_TILE_M, K.IP_TILE_N) == (_constant("IP_TM", scan),
                                          _constant("IP_TN", scan))
    # the tile each library reports at bind time is the pipelined scan's
    for src, fn in (("gleanvec_sq.cu", "gleanvec_sq_sorted_tile"),
                    ("dense_scores.cu", "sq_dot_tile")):
        text = (CSRC / src).read_text()
        assert re.search(rf"int {fn}\(int which\) \{{ return which == 0 \? "
                         r"IP_TM : IP_TN; \}", text), (src, fn)
        assert '#include "ip_scan.cuh"' in text
    # sq_dot and the sorted top-k launch the pipelined scan only
    dense = (CSRC / "dense_scores.cu").read_text()
    body = dense[dense.index('extern "C" int sq_dot_u8('):]
    body = body[:body.index("\n}\n")]
    assert "launch_ip_dense" in body and "gemm" not in body
    sq = (CSRC / "gleanvec_sq.cu").read_text()
    body = sq[sq.index("static int sorted_impl("):]
    body = body[:body.index("\n}\n")]
    assert "launch_ip_seg_scan" in body and "gemm" not in body
    # so does the sorted dense gleanvec_sq; scan_gemm.cuh keeps only the
    # gathered (bucketed) scans
    body = dense[dense.index("static int sorted_dense("):]
    body = body[:body.index("\n}\n")]
    assert "launch_ip_dense" in body and "gemm" not in body
    for fn in ("gleanvec_sq_dense_sorted_f32", "gleanvec_sq_dense_sorted_u8"):
        body = dense[dense.index(f'extern "C" int {fn}('):]
        body = body[:body.index("\n}\n")]
        assert "sorted_dense<" in body and "gemm" not in body, fn
    assert "ROWS" not in (CSRC / "scan_gemm.cuh").read_text()


def _smem(scan, chunk, views, k, dense=False):
    """ip_scan_smem of ``ip_scan.cuh`` from its constants: the ring (query
    slabs, rows), the side buffers, then the fold's lists, candidates,
    counts and profile (or DENSE's staging)."""
    tm, tn = _constant("IP_TM", scan), _constant("IP_TN", scan)
    stages, cap = _constant("IP_STAGES", scan), _constant("IP_CAP", scan)
    threads = _constant("IP_THREADS", scan)
    qstr, xstr = chunk
    vp = max(views, 1)
    stage = vp * tm * qstr * 4 + tn * xstr
    side = 0 if views == 0 else (tn + vp * tm) * 4
    ring = stages * (stage + side)
    if dense:
        return ring + threads // 32 * 4 * (16 * 8 + 8) * 4
    return ring + tm * k * 8 + tm * cap * 8 + tm * 20 + 6 * 8


def test_one_view_fits_at_every_pass_length():
    """One view a tile takes any layout block, so it must fit a block's
    shared memory at every pass length, f32 and u8; two views fit u8 at
    every pass length and f32 up to the library's bound (k <= 104)."""
    scan = (CSRC / "ip_scan.cuh").read_text()
    limit = _constant("IP_SMEM_MAX", scan)
    f32, u8 = (20, 80), (20, 20)
    assert _smem(scan, f32, 0, K.PASS_K) <= limit     # ip_topk, as before
    for chunk in (f32, u8):
        assert _smem(scan, chunk, 1, K.PASS_K) <= limit
    assert _smem(scan, u8, 2, K.PASS_K) <= limit
    assert _smem(scan, f32, 2, 104) <= limit < _smem(scan, f32, 2, 105)
    assert _smem(scan, u8, 1, 0, dense=True) <= limit
    for chunk in (f32, u8):            # the sorted dense scan's two views
        assert _smem(scan, chunk, 2, 0, dense=True) <= limit
    # the chunk strides the mirror assumes
    for xt, (qstr, xstr) in (("float", f32), ("uint8_t", u8)):
        spec = scan[scan.index(f"struct IpChunk<{xt}>"):]
        spec = spec[:spec.index("};")]
        assert (_constant("QSTR", spec), _constant("XSTR", spec)) == \
            (qstr, xstr)


# ---------------------------------------------------------------------------
# CPU: against the JAX reference.
# ---------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _norm(a):
    a = np.asarray(a, np.float64)
    return float(np.linalg.norm(a.reshape(-1, a.shape[-1]), axis=1).max())


def _sorted_case(seed, m, nb, c, d, lb, u8):
    rng = np.random.default_rng(seed)
    n = nb * lb
    q_scaled = rng.standard_normal((m, c, d)).astype(np.float32)
    q_lo = rng.standard_normal((m, c)).astype(np.float32)
    codes = (rng.integers(0, 256, (n, d)).astype(np.uint8) if u8
             else rng.standard_normal((n, d)).astype(np.float32))
    block_tags = rng.integers(0, c, nb).astype(np.int32)
    perm = np.full(n, -1, np.int32)
    live = np.sort(rng.permutation(n)[: n - n // 5])
    perm[live] = rng.permutation(live.size).astype(np.int32)
    return q_scaled, q_lo, block_tags, codes, perm


@pytest.mark.parametrize("m,nb,c,d,lb,k,u8", [
    (7, 6, 4, 16, 256, 100, True),     # the stream's layout block
    (5, 5, 3, 24, 256, 200, False),    # and kappa = 200 (two passes)
    (6, 3, 2, 16, 512, 200, True),     # kappa = 200 over whole tiles
])
def test_sorted_topk_matches_reference(m, nb, c, d, lb, k, u8):
    from jax import numpy as jnp
    from repro.kernels import gleanvec_sq_topk, gleanvec_sq_topk_ref

    q_scaled, q_lo, btags, codes, perm = _sorted_case(
        nb * 31 + lb + k, m, nb, c, d, lb, u8)
    tol = dot_tol(_norm(q_scaled), _norm(codes), d, float(np.abs(q_lo).max()))
    port = K.gleanvec_sq_topk(_t(q_scaled), _t(q_lo), _t(btags), _t(codes),
                              k, row_ids=_t(perm), layout_block=lb)
    args = (jnp.asarray(q_scaled), jnp.asarray(q_lo), jnp.asarray(btags),
            jnp.asarray(codes), k)
    pallas = gleanvec_sq_topk(*args, row_ids=jnp.asarray(perm),
                              layout_block=lb, tm=4, interpret=True)
    ref = gleanvec_sq_topk_ref(*args, row_ids=jnp.asarray(perm),
                               layout_block=lb)
    assert port[0].shape == (m, k) and port[1].dtype == torch.int32
    assert_topk_close(port, pallas, tol, f"L={lb} k={k} plain vs pallas")
    assert_topk_close(port, ref, tol, f"L={lb} k={k} plain vs ref")
    assert (port[1].numpy() >= 0).all()            # padding never listed


@pytest.mark.parametrize("m,n,d", [(65, 1030, 16), (1, 513, 7),
                                   (70, 2049, 33)])
def test_sq_dot_off_the_tiles_matches_reference(m, n, d):
    from jax import numpy as jnp
    from repro.kernels import sq_dot, sq_dot_ref

    rng = np.random.default_rng(m * 7 + n + d)
    q = rng.standard_normal((m, d)).astype(np.float32)
    codes = rng.integers(0, 256, (n, d)).astype(np.uint8)
    lo = rng.standard_normal(d).astype(np.float32)
    delta = (rng.random(d) + 0.01).astype(np.float32)
    port = K.sq_dot(_t(q), _t(codes), _t(lo), _t(delta)).numpy()
    qs = q * delta
    tol = dot_tol(_norm(qs), _norm(codes), d, float(np.abs(q @ lo).max()))
    args = tuple(jnp.asarray(a) for a in (q, codes, lo, delta))
    assert port.shape == (m, n) and port.dtype == np.float32
    for other in (sq_dot(*args, interpret=True), sq_dot_ref(*args)):
        np.testing.assert_allclose(port, np.asarray(other), rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# The card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _int_case(g, dev, m, n, c, d, lb, u8):
    """Small integers everywhere, so every score is exact in fp32."""
    nb = -(-n // lb)
    qs = torch.randint(-3, 4, (m, c, d), generator=g, device=dev).float()
    qlo = torch.randint(-50, 51, (m, c), generator=g, device=dev).float()
    x = (torch.randint(0, 4, (n, d), generator=g, device=dev,
                       dtype=torch.uint8) if u8 else
         torch.randint(-3, 4, (n, d), generator=g, device=dev).float())
    btags = torch.randint(0, c, (nb,), generator=g, device=dev,
                          dtype=torch.int32)
    rid = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    rid[torch.rand(n, generator=g, device=dev) < 0.2] = -1
    return qs, qlo, btags, x, rid


@pytest.mark.cuda
@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("lb", [1, 64, 200, 256, 512, 4096])
def test_cuda_sorted_topk_exact_on_integer_data(cuda, lb, u8):
    g = torch.Generator(device=cuda).manual_seed(lb * 2 + u8)
    for m, n, c, d in ((1, 300 if lb == 1 else 3001, 3, 20),
                       (70, 2 * lb + 37 if lb > 200 else 2999, 5, 16),
                       (130, 9000, 4, 33)):
        if lb == 1 and n > 1000:
            n = 1000                     # a tile a row
        qs, qlo, btags, x, rid = _int_case(g, cuda, m, n, c, d, lb, u8)
        for k in (1, 10, 100, 200):
            got = K.gleanvec_sq_topk(qs, qlo, btags, x, k, row_ids=rid,
                                     layout_block=lb)
            want = exact_sorted_topk(qs, qlo, btags, x, rid, k, lb)
            label = f"L={lb} {'u8' if u8 else 'f32'} M={m} N={n} d={d} k={k}"
            assert torch.equal(got[0], want[0]), label
            assert torch.equal(got[1], want[1]), label
            assert_topk_close(got, K.gleanvec_sq_topk_plain(
                qs, qlo, btags, x, k, row_ids=rid, layout_block=lb), 0.0,
                label)


@pytest.mark.cuda
@pytest.mark.parametrize("lb", [64, 256, 4096])
def test_cuda_sorted_topk_tie_across_layout_blocks(cuda, lb):
    """Equal scores in layout blocks of different tags, each through its
    own view (view t reads depth t of rows that hold 2 at every depth):
    the smaller ids win, across blocks and across the two views of a
    tile."""
    d, c, nb = 16, 4, 6
    n = nb * lb
    x = torch.full((n, d), 2.0, device=cuda)
    qs = torch.zeros(3, c, d, device=cuda)
    for t in range(c):
        qs[:, t, t] = 1.0
    qlo = torch.zeros(3, c, device=cuda)
    btags = (torch.arange(nb, device=cuda) % c).to(torch.int32)
    rid = torch.randperm(n, device=cuda).to(torch.int32)
    for k in (10, 200):
        vals, ids = K.gleanvec_sq_topk(qs, qlo, btags, x, k, row_ids=rid,
                                       layout_block=lb)
        want = torch.sort(rid).values[:k].expand(3, -1)
        assert torch.equal(ids, want), (lb, k)
        assert bool((vals == 2.0).all()), (lb, k)


def _int_sq(g, dev, m, n, d, shift):
    q = torch.randint(-3, 4, (m, d), generator=g, device=dev).float()
    lo = torch.randint(-40, 41, (m,), generator=g, device=dev).float()
    buf = torch.randint(0, 256, (n * d + shift,), generator=g, device=dev,
                        dtype=torch.uint8)
    return q, lo, buf[shift:].view(n, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 160, 513])
def test_cuda_sq_dot_bit_for_bit_on_integer_data(cuda, d):
    g = torch.Generator(device=cuda).manual_seed(d)
    for m, n, shift in ((1, 1, 0), (70, 5003, 0), (1030, 2049, 1),
                        (64, 512, 3)):
        q, lo, codes = _int_sq(g, cuda, m, n, d, shift)
        got = K.sq_dot_folded(q, lo, codes)
        want = K.sq_dot_folded_plain(q, lo, codes)
        assert got.shape == (m, n)
        assert torch.equal(got, want), (d, m, n, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("lb", [1, 64, 200, 256, 768, 4096])
def test_cuda_sorted_dense_bit_for_bit_on_integer_data(cuda, lb, u8):
    g = torch.Generator(device=cuda).manual_seed(lb * 2 + u8)
    for m, nb, cut, c, d in ((1, 5, 0, 3, 20), (70, 7, 37, 5, 160),
                             (130, 3, 1, 4, 33)):
        if lb == 1:
            nb, cut = 900, 0
        n = nb * lb - cut
        qs, qlo, btags, x, _ = _int_case(g, cuda, m, n, c, d, lb, u8)
        got = K.gleanvec_sq(qs, qlo, btags, x, layout_block=lb)
        want = K.gleanvec_sq_plain(qs, qlo, btags, x, layout_block=lb)
        assert got.shape == (m, n)
        assert torch.equal(got, want), (lb, u8, m, n)


@pytest.mark.cuda
def test_cuda_sorted_topk_and_sq_dot_are_deterministic(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    for lb, u8 in ((256, False), (256, True), (4096, True), (200, False)):
        n = 20 * lb if lb > 200 else 9000
        qs = torch.randn(1024, 6, 160, generator=g, device=cuda)
        qlo = torch.randn(1024, 6, generator=g, device=cuda)
        x = (torch.randint(0, 256, (n, 160), generator=g, device=cuda,
                           dtype=torch.uint8) if u8 else
             torch.randn(n, 160, generator=g, device=cuda))
        btags = torch.randint(0, 6, (-(-n // lb),), generator=g, device=cuda,
                              dtype=torch.int32)
        rid = torch.arange(n, dtype=torch.int32, device=cuda)
        a = K.gleanvec_sq_topk(qs, qlo, btags, x, 100, row_ids=rid,
                               layout_block=lb)
        b = K.gleanvec_sq_topk(qs, qlo, btags, x, 100, row_ids=rid,
                               layout_block=lb)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    q = torch.randn(1024, 160, generator=g, device=cuda)
    lo = torch.randn(1024, generator=g, device=cuda)
    codes = torch.randint(0, 256, (50_000, 160), generator=g, device=cuda,
                          dtype=torch.uint8)
    assert torch.equal(K.sq_dot_folded(q, lo, codes),
                       K.sq_dot_folded(q, lo, codes))


@pytest.mark.cuda
def test_cuda_sorted_topk_and_sq_dot_never_take_the_plain_path(
        cuda, monkeypatch):
    gsq = importlib.import_module("repro_torch.kernels.gleanvec_sq")
    sqd = importlib.import_module("repro_torch.kernels.sq_dot")

    def refuse(*a, **k):
        raise AssertionError("plain path taken for a CUDA tensor")

    monkeypatch.setattr(gsq, "gleanvec_sq_topk_plain", refuse)
    monkeypatch.setattr(sqd, "sq_dot_folded_plain", refuse)
    before = (K.gleanvec_sq_topk.launches, K.sq_dot.launches)
    calls = 0
    for lb in (1, 64, 200, 256, 4096):
        for k in (10, 200):
            for u8 in (False, True):
                n = 3 * lb + 5 if lb > 64 else 700
                x = (torch.zeros(n, 16, dtype=torch.uint8, device=cuda) if u8
                     else torch.randn(n, 16, device=cuda))
                K.gleanvec_sq_topk(
                    torch.randn(5, 3, 16, device=cuda),
                    torch.zeros(5, 3, device=cuda),
                    torch.zeros(-(-n // lb), dtype=torch.int32, device=cuda),
                    x, k, row_ids=torch.arange(n, dtype=torch.int32,
                                               device=cuda),
                    layout_block=lb)
                calls += 1
    K.sq_dot(torch.randn(5, 16, device=cuda),
             torch.zeros(300, 16, dtype=torch.uint8, device=cuda),
             torch.zeros(16, device=cuda), torch.ones(16, device=cuda))
    torch.cuda.synchronize()
    assert (K.gleanvec_sq_topk.launches, K.sq_dot.launches) == \
        (before[0] + calls, before[1] + 1)
    monkeypatch.setattr(gsq, "gleanvec_sq_plain", refuse)
    dense = K.gleanvec_sq.launches
    for lb in (64, 256, 768):
        n = 3 * lb + 5
        K.gleanvec_sq(torch.randn(5, 3, 16, device=cuda),
                      torch.zeros(5, 3, device=cuda),
                      torch.zeros(-(-n // lb), dtype=torch.int32,
                                  device=cuda),
                      torch.zeros(n, 16, dtype=torch.uint8, device=cuda),
                      layout_block=lb)
    torch.cuda.synchronize()
    assert K.gleanvec_sq.launches == dense + 3
