"""Fused sorted-IVF range scan + top-k (the gather-free IVF fine step):
CUDA kernel (``csrc/ivf_scan.cu``), its plain PyTorch version, the wrapper,
and the kernel's traffic model.

Port of ``repro/kernels/ivf_scan`` (TPU kernel ``ivf_scan_topk``, body
``_range_scan_kernel``; oracles ``ivf_scan_topk_ref`` /
``ivf_scan_scores_ref``). ``sched (M, S)`` lists the layout blocks each
query visits (-1 = pad slot); every valid slot's single-tag slab is scored

    score[m, n] = <q_scaled[m, tag_b], codes_n> + q_lo[m, tag_b]

and the top k per query come out with ids from ``row_ids`` (-1 rows never
win; -inf winners carry id -1). A tile of the kernel never crosses a layout
block, so any ``layout_block`` works (the reference's tile-shrink fallback
is not needed). Block indices outside [0, NB) count as pad slots.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.index.topk import NEG_INF

__all__ = ["ivf_scan_topk", "ivf_scan_topk_plain", "fine_step_bytes"]

_ID_LAST = 2 ** 31      # sort key of id -1: after every real id


def _best_first(vals, ids, k: int):
    """The first ``k`` of each row in the kernels' order: value descending,
    then id ascending with -1 last (two stable sorts)."""
    key = torch.where(ids >= 0, ids.to(torch.int64),
                      torch.full_like(ids, _ID_LAST, dtype=torch.int64))
    o = torch.sort(key, dim=1, stable=True).indices
    vals, ids = torch.gather(vals, 1, o), torch.gather(ids, 1, o)
    o = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(vals, 1, o), torch.gather(ids, 1, o)


def ivf_scan_topk_plain(q_scaled, q_lo, block_tags, row_ids, codes, sched,
                        k: int, layout_block: int):
    """The kernel's function in plain PyTorch, organised as the kernel is:
    each scheduled block's rows are scored once against all the (query,
    slot) pairs that visit it (one product per block), each pair keeps its
    top ``k`` as a partial list, and the (M, S * k) partial lists are
    merged. Peak memory is one block's (pairs, layout_block) scores plus
    the (M, S, k) partials -- never the reference oracle's (M, S * L, d)
    gather."""
    m, s = sched.shape
    dev = q_scaled.device
    n = codes.shape[0]
    nb = block_tags.shape[0]
    slots = max(s, 1)           # an empty schedule keeps one empty list
    pv = torch.full((m, slots, k), NEG_INF, dtype=torch.float32, device=dev)
    pi = torch.full((m, slots, k), -1, dtype=torch.int32, device=dev)
    pm, ps = torch.nonzero((sched >= 0) & (sched < nb), as_tuple=True)
    blk = sched[pm, ps].to(torch.int64)
    order = torch.argsort(blk, stable=True)
    pm, ps, blk = pm[order], ps[order], blk[order]
    blocks, counts = torch.unique_consecutive(blk, return_counts=True)
    start = 0
    for b, cnt in zip(blocks.tolist(), counts.tolist()):
        qm, sl = pm[start:start + cnt], ps[start:start + cnt]
        start += cnt
        r0, r1 = b * layout_block, min((b + 1) * layout_block, n)
        tag = int(block_tags[b])
        rows = codes[r0:r1].to(torch.float32)
        scores = q_scaled[qm, tag].to(torch.float32) @ rows.T \
            + q_lo[qm, tag].to(torch.float32)[:, None]
        rid = row_ids[r0:r1].to(torch.int32)
        ok = rid >= 0
        scores = torch.where(ok[None, :], scores,
                             torch.full_like(scores, NEG_INF))
        ids = torch.where(ok, rid, torch.full_like(rid, -1)).expand(cnt, -1)
        if r1 - r0 < k:
            pad = k - (r1 - r0)
            scores = torch.cat([scores, torch.full((cnt, pad), NEG_INF,
                                                   device=dev)], dim=1)
            ids = torch.cat([ids, torch.full((cnt, pad), -1,
                                             dtype=torch.int32, device=dev)],
                            dim=1)
        v, i = _best_first(scores, ids, k)
        pv[qm, sl] = v
        pi[qm, sl] = i
    vals, ids = _best_first(pv.reshape(m, slots * k),
                            pi.reshape(m, slots * k), k)
    return vals, torch.where(vals > NEG_INF, ids, torch.full_like(ids, -1))


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "u8"):
        fn = getattr(lib, f"ivf_scan_topk_{dt}")
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    lib.ivf_scan_workspace_bytes.argtypes = [i, i, i, i]
    lib.ivf_scan_workspace_bytes.restype = ctypes.c_longlong


def ivf_scan_topk(q_scaled, q_lo, block_tags, row_ids, codes, sched, k: int,
                  layout_block: int):
    """``q_scaled (M, C, d)`` f32, ``q_lo (M, C)`` f32, ``block_tags (NB,)``
    i32 (``NB = ceil(N / layout_block)``), ``row_ids (N,)`` i32, ``codes
    (N, d)`` u8 or f32, ``sched (M, S)`` i32 layout-block indices (-1 =
    pad) -> (vals (M, k) f32, ids (M, k) i32), best first, ids ORIGINAL
    (-1 for -inf winners).

    CPU tensors take :func:`ivf_scan_topk_plain`; CUDA tensors launch the
    kernel or raise."""
    from repro_torch import kernels as K
    args = dict(q_scaled=q_scaled, q_lo=q_lo, block_tags=block_tags,
                row_ids=row_ids, codes=codes, sched=sched)
    if K.on_cpu(*args.values()):
        return ivf_scan_topk_plain(q_scaled, q_lo, block_tags, row_ids,
                                   codes, sched, k, layout_block)
    K.check_cuda_inputs("ivf_scan_topk", **args)
    if q_scaled.dtype != torch.float32 or q_lo.dtype != torch.float32 \
            or codes.dtype not in (torch.float32, torch.uint8) \
            or any(t.dtype != torch.int32
                   for t in (block_tags, row_ids, sched)):
        raise TypeError("ivf_scan_topk takes f32 q_scaled/q_lo, f32 or u8 "
                        "codes and i32 block_tags/row_ids/sched")
    m, c, d = q_scaled.shape
    n = codes.shape[0]
    if layout_block <= 0:
        raise ValueError("ivf_scan_topk needs layout_block > 0")
    nb = -(-n // layout_block)
    if q_lo.shape != (m, c) or codes.shape != (n, d) \
            or block_tags.shape != (nb,) or row_ids.shape != (n,) \
            or sched.ndim != 2 or sched.shape[0] != m:
        raise ValueError("ivf_scan_topk shapes do not agree")
    K.check_k(k)
    s = sched.shape[1]
    dev = q_scaled.device
    vals = torch.empty((m, k), dtype=torch.float32, device=dev)
    ids = torch.empty((m, k), dtype=torch.int32, device=dev)
    if m == 0:
        return vals, ids
    lib = K.load_library("ivf_scan", _bind)
    ws = torch.empty(lib.ivf_scan_workspace_bytes(m, s, nb, k),
                     dtype=torch.uint8, device=dev)
    dt = "f32" if codes.dtype == torch.float32 else "u8"
    err = getattr(lib, f"ivf_scan_topk_{dt}")(
        q_scaled.data_ptr(), q_lo.data_ptr(), block_tags.data_ptr(),
        row_ids.data_ptr(), codes.data_ptr(), sched.data_ptr(), m, c, d, n,
        nb, layout_block, s, k, ws.data_ptr(), vals.data_ptr(),
        ids.data_ptr(), K.current_stream(dev))
    K.check_launch("ivf_scan_topk", err, lib)
    ivf_scan_topk.launches += 1
    return vals, ids


ivf_scan_topk.launches = 0


def fine_step_bytes(m: int, blocks_visited: int, layout_block: int, d: int,
                    c: int, code_bytes: int = 1, k: int = 10) -> float:
    """Device-memory bytes the TPU range-scan kernel moves for one query
    batch (the reference's traffic model, as arithmetic): per visited slab
    ``layout_block * (d * code_bytes + 4) + 4``, per query ``C * d * 4 +
    C * 4 + 8 k``. ``blocks_visited`` counts the VALID schedule entries
    across the batch."""
    per_block = layout_block * (d * code_bytes + 4) + 4
    per_query = c * d * 4 + c * 4 + 2 * k * 4
    return float(m * per_query + blocks_visited * per_block)
