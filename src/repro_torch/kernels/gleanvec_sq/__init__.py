"""GleanVec (o int8) scores: the fused scan + top-k (``gleanvec_sq_topk``,
CUDA kernel in ``csrc/gleanvec_sq.cu``) and the dense scores
(``gleanvec_sq``, in ``csrc/dense_scores.cu``), each with its plain PyTorch
version and wrapper.

Ports of ``repro/kernels/gleanvec_sq`` (TPU kernels ``gleanvec_sq_topk``,
body ``_topk_kernel``, and ``gleanvec_sq``, body ``_dense_kernel``):

    score[m, n] = <q_scaled[m, tag_n], codes_n> + q_lo[m, tag_n]

``layout_block == 0``: gathered layout, ``tags (N,)`` per row; the
kernels first bucket the rows by tag (``bucket_rows_by_tag``, per call) so
that every 128-row tile has one view, as in the sorted layout.
``layout_block > 0``: tag-sorted layout, ``tags (ceil(N / layout_block),)``
per block; the pipelined scan (``csrc/ip_scan.cuh``) multiplies every row
by its own block's view only, so any block size works (the reference's
tile-shrink / gathered fallbacks are not needed); the launch shapes are
:func:`sorted_scan_plan` (top-k) and :func:`sorted_dense_plan` (dense).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.index.topk import NEG_INF, blocked_topk
from repro_torch.kernels.ip_topk import ScanPlan, split_plan

__all__ = ["gleanvec_sq_topk", "gleanvec_sq_topk_plain", "gleanvec_sq",
           "gleanvec_sq_plain", "tile_scores", "dense_plain",
           "bucket_rows_by_tag", "bucket_rows_by_tag_plain", "bucket_tiles",
           "bucket_workspace", "dense_buffer", "sorted_tiles",
           "sorted_scan_plan", "sorted_dense_plan"]

BUCKET_TILE = 128       # slots per tile of the bucketed layout (scan_gemm.cuh)
DENSE_BUFFER = 1 << 28  # most floats of the gathered dense kernels' buffer


def _row_tags(tags, start, size, layout_block):
    if layout_block > 0:
        rows = torch.arange(start, start + size, device=tags.device)
        return tags[rows // layout_block]
    return tags[start:start + size]


def tile_scores(q_scaled, q_lo, row_tags, rows):
    """(M, R) scores of ``rows (R, d)`` whose views are ``row_tags (R,)``:
    one matmul per cluster present, ``q_scaled[:, c] @ rows[of c].T +
    q_lo[:, c]`` -- never the dense (M, R, d) view gather. A tag outside
    [0, C) (a padding block of a stacked shard: -1) reads the nearest
    view, as the kernels clamp it; such rows carry ``row_ids`` -1."""
    q_scaled = q_scaled.to(torch.float32)
    rows = rows.to(torch.float32)
    t = row_tags.to(torch.int64).clamp(0, q_scaled.shape[1] - 1)
    out = torch.empty((q_scaled.shape[0], rows.shape[0]), dtype=torch.float32,
                      device=q_scaled.device)
    for c in torch.unique(t).tolist():
        sel = torch.nonzero(t == c).squeeze(1)
        out[:, sel] = (q_scaled[:, c] @ rows[sel].T
                       + q_lo[:, c:c + 1].to(torch.float32))
    return out


def gleanvec_sq_topk_plain(q_scaled, q_lo, tags, codes, k: int,
                           row_ids=None, layout_block: int = 0,
                           block: int = 65536):
    """Blocked over N, scoring each block with :func:`tile_scores`. Rows
    with ``row_ids < 0`` score NEG_INF and come out as id -1."""
    m = q_scaled.shape[0]

    def score(start, size):
        out = tile_scores(q_scaled, q_lo,
                           _row_tags(tags, start, size, layout_block),
                           codes[start:start + size])
        if row_ids is not None:
            ok = row_ids[start:start + size] >= 0
            out = torch.where(ok[None, :], out, torch.full_like(out, NEG_INF))
        return out

    vals, idx = blocked_topk(score, codes.shape[0], k, block, m,
                             q_scaled.device)
    if row_ids is None:
        return vals, idx
    ids = torch.where(idx >= 0, row_ids.to(torch.int32)[idx.clamp(min=0).long()],
                      torch.full_like(idx, -1))
    return vals, ids


def dense_plain(score_block_fn, n: int, m: int, device, block: int = 65536):
    """(m, n) f32 matrix filled block by block by ``score_block_fn(start,
    size) -> (m, size)``: the dense kernels' plain versions, whose
    temporaries stay one block wide."""
    out = torch.empty((m, n), dtype=torch.float32, device=device)
    for start in range(0, n, block):
        size = min(block, n - start)
        out[:, start:start + size] = score_block_fn(start, size)
    return out


def gleanvec_sq_plain(q_scaled, q_lo, tags, codes, layout_block: int = 0,
                      block: int = 65536):
    """Dense (M, N) f32 scores, blocked over N (:func:`tile_scores`)."""

    def score(start, size):
        return tile_scores(q_scaled, q_lo,
                           _row_tags(tags, start, size, layout_block),
                           codes[start:start + size])

    return dense_plain(score, codes.shape[0], q_scaled.shape[0],
                       q_scaled.device, block)


def bucket_tiles(n: int, c: int) -> int:
    """Tiles of the bucketed layout of ``n`` rows and ``c`` tags: a bound
    on ``sum_c ceil(n_c / 128)`` (the tiles past the used ones are all
    padding)."""
    return (n + (BUCKET_TILE - 1) * c) // BUCKET_TILE


def sorted_tiles(n: int, layout_block: int, views: int) -> int:
    """Tiles of the sorted scan over ``n`` rows in layout blocks of
    ``layout_block``: with two views a tile (``views == 2``, half a tile a
    view) the plain ``K.IP_TILE_N``-row tiles, else ceil(layout_block /
    ``K.IP_TILE_N``) tiles a layout block, cut at its end."""
    from repro_torch import kernels as K
    if views == 2:
        return -(-n // K.IP_TILE_N)
    return -(-n // layout_block) * -(-layout_block // K.IP_TILE_N)


def sorted_scan_plan(m: int, n: int, k: int, layout_block: int, views: int,
                     sms: int) -> ScanPlan:
    """The launch shape of the sorted ``gleanvec_sq_topk`` on a card with
    ``sms`` SMs: ``ip_topk.split_plan`` (one wave of one block an SM) over
    :func:`sorted_tiles`. ``views`` is the library's
    ``gleanvec_sq_sorted_views(layout_block, k, u8)``: 2 where half a tile
    divides the layout block but a tile does not and two query slabs fit
    (the stream's layout block of 256), else 1."""
    if views not in (1, 2):
        raise ValueError(f"the sorted scan takes 1 or 2 views, got {views}")
    return split_plan(m, sorted_tiles(n, layout_block, views), k, sms)


def sorted_dense_plan(m: int, n: int, layout_block: int, views: int,
                      sms: int) -> ScanPlan:
    """The grid of the sorted dense ``gleanvec_sq`` on a card with ``sms``
    SMs: the one-wave split of :func:`sorted_tiles` (``sq_dot``'s plan with
    views). ``views`` is the library's
    ``gleanvec_sq_dense_sorted_views(layout_block, u8)``: 2 where half a
    tile divides the layout block but a tile does not, else 1. The blocks
    write disjoint columns: no partial lists, no merge."""
    if views not in (1, 2):
        raise ValueError(f"the sorted scan takes 1 or 2 views, got {views}")
    return split_plan(m, sorted_tiles(n, layout_block, views), 1,
                      sms)._replace(partial_shape=None)


def bucket_rows_by_tag_plain(tags, c: int):
    """The gathered layout's rows grouped by tag: ``tags (N,)`` (clamped to
    [0, c), as the kernels clamp a view index) -> ``(rows (T * 128,) i32,
    tile_tags (T,) i32)``, ``T = bucket_tiles(N, c)``. Tag 0's rows first,
    each tag's rows in ascending order and padded with -1 to a multiple of
    128, so every 128-slot tile holds one tag; the tiles past the used ones
    are all -1 with tag 0."""
    t = tags.to(torch.int64).clamp(0, c - 1)
    n = t.numel()
    dev = tags.device
    counts = torch.bincount(t, minlength=c)
    tiles = (counts + BUCKET_TILE - 1) // BUCKET_TILE
    first_slot = (torch.cumsum(tiles, 0) - tiles) * BUCKET_TILE
    order = torch.argsort(t, stable=True)
    st = t[order]
    first_rank = torch.cumsum(counts, 0) - counts
    pos = first_slot[st] + torch.arange(n, device=dev) - first_rank[st]
    n_tiles = bucket_tiles(n, c)
    rows = torch.full((n_tiles * BUCKET_TILE,), -1, dtype=torch.int32,
                      device=dev)
    rows[pos] = order.to(torch.int32)
    tile_tags = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    used = torch.repeat_interleave(torch.arange(c, device=dev), tiles)
    tile_tags[:used.numel()] = used.to(torch.int32)
    return rows, tile_tags


def bucket_workspace(lib, n: int, c: int, dev):
    """The bucketing's workspace on ``dev`` and the byte offsets of its
    counts, tile_tags, rows and slot_of (``csrc/bucket_rows.cuh``)."""
    off = (ctypes.c_longlong * 4)()
    nbytes = lib.gleanvec_sq_bucket_workspace(n, c, off)
    return torch.empty(nbytes, dtype=torch.uint8, device=dev), list(off)


def dense_buffer(m: int, n: int, c: int, dev):
    """The gathered dense kernels' slot-ordered score buffer for a chunk
    of queries (a multiple of 64, at most ``DENSE_BUFFER`` floats unless
    one tile of 64 queries needs more) and the chunk's size."""
    from repro_torch import kernels as K
    slots = bucket_tiles(n, c) * BUCKET_TILE
    tile = K.GEMM_TILE_M
    mc = min(m, max(tile, DENSE_BUFFER // max(slots, 1) // tile * tile))
    return torch.empty((mc, slots), dtype=torch.float32, device=dev), mc


def bucket_rows_by_tag(tags, c: int):
    """:func:`bucket_rows_by_tag_plain` for ``tags (N,)`` i32. CPU tensors
    take the plain version; CUDA tensors launch the bucketing kernels of
    ``csrc/bucket_rows.cuh`` (the first step of the gathered kernels, here
    on its own) or raise."""
    from repro_torch import kernels as K
    if K.on_cpu(tags):
        return bucket_rows_by_tag_plain(tags, c)
    K.check_cuda_inputs("bucket_rows_by_tag", tags=tags)
    if tags.dtype != torch.int32 or tags.ndim != 1 or c < 1:
        raise ValueError("bucket_rows_by_tag takes i32 tags (N,) and c >= 1")
    n = tags.shape[0]
    dev = tags.device
    lib = K.load_library("gleanvec_sq", _bind)
    ws, off = bucket_workspace(lib, n, c, dev)
    err = lib.gleanvec_sq_bucket_rows(tags.data_ptr(), n, c, ws.data_ptr(),
                                      K.current_stream(dev))
    K.check_launch("bucket_rows_by_tag", err, lib)
    K.count_launch(bucket_rows_by_tag)
    t = bucket_tiles(n, c)
    tile_tags = ws[off[1]:off[1] + 4 * t].view(torch.int32)
    rows = ws[off[2]:off[2] + 4 * t * BUCKET_TILE].view(torch.int32)
    return rows, tile_tags


bucket_rows_by_tag.launches = 0


def _bind(lib):
    from repro_torch import kernels as K
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "u8"):
        fn = getattr(lib, f"gleanvec_sq_gathered_topk_{dt}")
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"gleanvec_sq_sorted_topk_{dt}")
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p, p, p,
                       p]
        fn.restype = ctypes.c_int
    lib.gleanvec_sq_sorted_views.argtypes = [i, i, i]
    lib.gleanvec_sq_sorted_views.restype = ctypes.c_int
    lib.gleanvec_sq_sorted_tile.argtypes = [i]
    lib.gleanvec_sq_sorted_tile.restype = ctypes.c_int
    tile = (lib.gleanvec_sq_sorted_tile(0), lib.gleanvec_sq_sorted_tile(1))
    if tile != (K.IP_TILE_M, K.IP_TILE_N):
        raise RuntimeError(
            f"gleanvec_sq_topk: the sorted scan's tile {tile} is not "
            f"(IP_TILE_M, IP_TILE_N) = {(K.IP_TILE_M, K.IP_TILE_N)}: its "
            "partial lists would be sized wrong")
    lib.gleanvec_sq_bucket_workspace.argtypes = [
        i, i, ctypes.POINTER(ctypes.c_longlong)]
    lib.gleanvec_sq_bucket_workspace.restype = ctypes.c_longlong
    lib.gleanvec_sq_bucket_rows.argtypes = [p, i, i, p, p]
    lib.gleanvec_sq_bucket_rows.restype = ctypes.c_int


def gleanvec_sq_topk(q_scaled, q_lo, tags, codes, k: int, row_ids=None,
                     layout_block: int = 0):
    """Fused score + top-k. ``q_scaled (M, C, d)`` f32, ``q_lo (M, C)`` f32,
    ``codes (N, d)`` u8 or f32, ``row_ids (N,)`` i32 optional external id
    per row (-1 = masked; default: the row index) -> (vals (M, k) f32,
    ids (M, k) i32), best first. Any k >= 1 (above ``K.PASS_K`` the kernel
    scans in passes).

    The custom op ``repro_torch::gleanvec_sq_topk``: CPU tensors take
    :func:`gleanvec_sq_topk_plain`; CUDA tensors launch the kernel or
    raise; fake tensors get the output shapes and the kernel's flop count
    (2 d a (query, row)), for the dry run."""
    from repro_torch import kernels as K
    K.on_cpu(*(t for t in (q_scaled, q_lo, tags, codes, row_ids)
               if t is not None))               # raises on mixed devices
    return _gleanvec_sq_topk_op(q_scaled, q_lo, tags, codes, k, row_ids,
                                layout_block)


@torch.library.custom_op("repro_torch::gleanvec_sq_topk", mutates_args=(),
                         device_types="cpu")
def _gleanvec_sq_topk_op(q_scaled: torch.Tensor, q_lo: torch.Tensor,
                         tags: torch.Tensor, codes: torch.Tensor, k: int,
                         row_ids: Optional[torch.Tensor],
                         layout_block: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    return gleanvec_sq_topk_plain(q_scaled, q_lo, tags, codes, k,
                                  row_ids=row_ids, layout_block=layout_block)


@_gleanvec_sq_topk_op.register_fake
def _(q_scaled, q_lo, tags, codes, k, row_ids, layout_block):
    m = q_scaled.shape[0]
    return (q_scaled.new_empty((m, k), dtype=torch.float32),
            q_scaled.new_empty((m, k), dtype=torch.int32))


@register_flop_formula(torch.ops.repro_torch.gleanvec_sq_topk)
def _(q_scaled_shape, q_lo_shape, tags_shape, codes_shape, *args,
      out_shape=None, **kwargs) -> int:
    return 2 * q_scaled_shape[0] * codes_shape[0] * codes_shape[1]


@_gleanvec_sq_topk_op.register_kernel("cuda")
def _(q_scaled, q_lo, tags, codes, k, row_ids, layout_block):
    from repro_torch import kernels as K
    args = dict(q_scaled=q_scaled, q_lo=q_lo, tags=tags, codes=codes)
    if row_ids is not None:
        args["row_ids"] = row_ids
    K.check_cuda_inputs("gleanvec_sq_topk", **args)
    if q_scaled.dtype != torch.float32 or q_lo.dtype != torch.float32 \
            or codes.dtype not in (torch.float32, torch.uint8) \
            or tags.dtype != torch.int32 \
            or (row_ids is not None and row_ids.dtype != torch.int32):
        raise TypeError("gleanvec_sq_topk takes f32 q_scaled/q_lo, f32 or u8 "
                        "codes and i32 tags/row_ids")
    m, c, d = q_scaled.shape
    n = codes.shape[0]
    n_tags = -(-n // layout_block) if layout_block > 0 else n
    if q_lo.shape != (m, c) or codes.shape != (n, d) \
            or tags.shape != (n_tags,) \
            or (row_ids is not None and row_ids.shape != (n,)):
        raise ValueError("gleanvec_sq_topk shapes do not agree")
    K.check_k(k)
    dev = q_scaled.device
    vals = torch.empty((m, k), dtype=torch.float32, device=dev)
    ids = torch.empty((m, k), dtype=torch.int32, device=dev)
    if m == 0:
        return vals, ids
    lib = K.load_library("gleanvec_sq", _bind)
    dt = "f32" if codes.dtype == torch.float32 else "u8"
    rid = row_ids.data_ptr() if row_ids is not None else None
    stream = K.current_stream(dev)
    if layout_block > 0:
        views = lib.gleanvec_sq_sorted_views(layout_block, k,
                                             int(dt == "u8"))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = sorted_scan_plan(m, n, k, layout_block, views, sms)
        pv = torch.empty(plan.partial_shape, dtype=torch.float32, device=dev)
        pi = torch.empty(plan.partial_shape, dtype=torch.int32, device=dev)
        floors = torch.empty((m, 2 * plan.splits), dtype=torch.int32,
                             device=dev)     # rank-th and k-th values
        err = getattr(lib, f"gleanvec_sq_sorted_topk_{dt}")(
            q_scaled.data_ptr(), q_lo.data_ptr(), tags.data_ptr(), rid,
            codes.data_ptr(), m, c, d, n, layout_block, views, k,
            plan.splits, pv.data_ptr(), pi.data_ptr(), floors.data_ptr(),
            vals.data_ptr(), ids.data_ptr(), stream)
    else:
        s = K.splits(row_tiles=bucket_tiles(n, c),
                     query_blocks=-(-m // K.GEMM_TILE_M), k=k,
                     blocks_per_sm=2, device=dev)
        pv = torch.empty((m, s, K.pass_k(k)), dtype=torch.float32,
                         device=dev)
        pi = torch.empty((m, s, K.pass_k(k)), dtype=torch.int32, device=dev)
        ws, _ = bucket_workspace(lib, n, c, dev)
        err = getattr(lib, f"gleanvec_sq_gathered_topk_{dt}")(
            q_scaled.data_ptr(), q_lo.data_ptr(), tags.data_ptr(), rid,
            codes.data_ptr(), m, c, d, n, k, s, ws.data_ptr(), pv.data_ptr(),
            pi.data_ptr(), vals.data_ptr(), ids.data_ptr(), stream)
    K.check_launch("gleanvec_sq_topk", err, lib)
    K.count_launch(gleanvec_sq_topk)
    return vals, ids


gleanvec_sq_topk.launches = 0


def _bind_dense(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "u8"):
        fn = getattr(lib, f"gleanvec_sq_dense_gathered_{dt}")
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p, p, i, p, p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"gleanvec_sq_dense_sorted_{dt}")
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    lib.gleanvec_sq_dense_sorted_views.argtypes = [i, i]
    lib.gleanvec_sq_dense_sorted_views.restype = ctypes.c_int
    lib.dense_bucket_workspace_bytes.argtypes = [i, i]
    lib.dense_bucket_workspace_bytes.restype = ctypes.c_longlong


def gleanvec_sq(q_scaled, q_lo, tags, codes, layout_block: int = 0):
    """Dense scores. ``q_scaled (M, C, d)`` f32, ``q_lo (M, C)`` f32,
    ``codes (N, d)`` u8 or f32; ``tags (N,)`` i32 per row
    (``layout_block == 0``) or ``(ceil(N / layout_block),)`` per block of
    the tag-sorted layout -> (M, N) f32. Any block size works (the
    reference's tile-shrink / gathered fallbacks are not needed).

    CPU tensors take :func:`gleanvec_sq_plain`; CUDA tensors launch the
    kernel or raise."""
    from repro_torch import kernels as K
    if K.on_cpu(q_scaled, q_lo, tags, codes):
        return gleanvec_sq_plain(q_scaled, q_lo, tags, codes,
                                 layout_block=layout_block)
    K.check_cuda_inputs("gleanvec_sq", q_scaled=q_scaled, q_lo=q_lo,
                        tags=tags, codes=codes)
    if q_scaled.dtype != torch.float32 or q_lo.dtype != torch.float32 \
            or codes.dtype not in (torch.float32, torch.uint8) \
            or tags.dtype != torch.int32:
        raise TypeError("gleanvec_sq takes f32 q_scaled/q_lo, f32 or u8 "
                        "codes and i32 tags")
    m, c, d = q_scaled.shape
    n = codes.shape[0]
    n_tags = -(-n // layout_block) if layout_block > 0 else n
    if q_lo.shape != (m, c) or codes.shape != (n, d) \
            or tags.shape != (n_tags,):
        raise ValueError("gleanvec_sq shapes do not agree")
    dev = q_scaled.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    lib = K.load_library("dense_scores", _bind_dense)
    dt = "f32" if codes.dtype == torch.float32 else "u8"
    stream = K.current_stream(dev)
    if layout_block > 0:
        views = lib.gleanvec_sq_dense_sorted_views(layout_block,
                                                   int(dt == "u8"))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = sorted_dense_plan(m, n, layout_block, views, sms)
        err = getattr(lib, f"gleanvec_sq_dense_sorted_{dt}")(
            q_scaled.data_ptr(), q_lo.data_ptr(), tags.data_ptr(),
            codes.data_ptr(), m, c, d, n, layout_block, plan.splits,
            out.data_ptr(), stream)
    else:
        buf, mc = dense_buffer(m, n, c, dev)
        s = K.splits(row_tiles=bucket_tiles(n, c),
                     query_blocks=-(-mc // K.GEMM_TILE_M), k=1,
                     blocks_per_sm=3, device=dev)
        ws = torch.empty(lib.dense_bucket_workspace_bytes(n, c),
                         dtype=torch.uint8, device=dev)
        err = getattr(lib, f"gleanvec_sq_dense_gathered_{dt}")(
            q_scaled.data_ptr(), q_lo.data_ptr(), tags.data_ptr(),
            codes.data_ptr(), m, c, d, n, s, ws.data_ptr(), buf.data_ptr(),
            mc, out.data_ptr(), stream)
    K.check_launch("gleanvec_sq", err, lib)
    K.count_launch(gleanvec_sq)
    return out


gleanvec_sq.launches = 0
