"""Gather-free graph beam step (one hop of the fused graph traversal): CUDA
kernel (``csrc/graph_scan.cu``), its plain PyTorch version, the wrapper,
and the reference kernel's traffic model.

Port of ``repro/kernels/graph_scan`` (TPU kernel ``graph_scan_beam_step``,
body ``_beam_step_kernel``; oracles ``graph_scan_beam_step_ref`` /
``graph_scan_scores_ref``). A hop's neighbor rows ``nbr_rows (M, S)`` are
SORTED-ROW indices of a tag-sorted layout (-1 = pad, any order, repeats
allowed); each distinct live row is scored once,

    score = <q_scaled[m, tag], codes[row]> + q_lo[m, tag],
    tag = block_tags[row // layout_block],

with its ORIGINAL id ``row_ids[row]``, and the result is the top-B multiset
of the incoming beam together with the candidates that are not already in
it (ids compared). Masked candidates (pads, repeats, dead rows with
``row_ids == -1``, ids already in the beam) carry (NEG_INF, -1).

The TPU kernel folds candidates into the beam in slot order; the kernel
here and its plain version return the beam sorted best first (value
descending, then id ascending with -1 last), as the reference's oracle
returns it sorted. Every consumer ignores the order: the traversal's pop
and final top-k, and the visited flags it transfers by id.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.index.topk import NEG_INF

__all__ = ["graph_scan_beam_step", "graph_scan_beam_step_plain",
           "graph_scan_scores_plain", "beam_step_bytes", "fresh_slab_count",
           "MAX_S"]

MAX_S = 4096            # most neighbor rows a hop may carry per query
SMEM_CAP = 232448       # bytes of shared memory one block may use (sm_90)
_ID_LAST = 2 ** 31      # sort key of id -1: after every real id


def graph_scan_scores_plain(q_scaled, q_lo, block_tags, row_ids, codes,
                            nbr_rows, layout_block: int):
    """Dense per-candidate scores ``(scores, ids)``, both ``(M, S)`` in
    ascending sorted-row order: repeated rows (after the first), pad slots
    and dead rows score NEG_INF with id -1. The beam dedupe is not applied
    here (it needs the beam; see :func:`graph_scan_beam_step_plain`)."""
    m, _ = nbr_rows.shape
    n = codes.shape[0]
    rows = torch.sort(torch.where((nbr_rows >= 0) & (nbr_rows < n),
                                  nbr_rows.to(torch.int64),
                                  torch.full_like(nbr_rows, n,
                                                  dtype=torch.int64)),
                      dim=1).values
    valid = rows < n
    dup = torch.cat([torch.zeros((m, 1), dtype=torch.bool,
                                 device=rows.device),
                     rows[:, 1:] == rows[:, :-1]], dim=1)
    safe = torch.where(valid, rows, torch.zeros_like(rows))
    x = codes[safe].to(torch.float32)                           # (M, S, d)
    tag = block_tags[safe // layout_block].to(torch.int64)      # (M, S)
    q_sel = q_scaled[torch.arange(m, device=rows.device)[:, None], tag]
    scores = torch.sum(q_sel.to(torch.float32) * x, dim=-1) \
        + torch.gather(q_lo.to(torch.float32), 1, tag)
    ids = torch.where(valid, row_ids[safe].to(torch.int32),
                      torch.full_like(safe, -1, dtype=torch.int32))
    ok = valid & ~dup & (ids >= 0)
    return (torch.where(ok, scores, torch.full_like(scores, NEG_INF)),
            torch.where(ok, ids, torch.full_like(ids, -1)))


def graph_scan_beam_step_plain(q_scaled, q_lo, block_tags, row_ids, codes,
                               nbr_rows, beam_vals, beam_ids,
                               layout_block: int):
    """The hop in plain PyTorch, as the reference's oracle: gather and
    score (:func:`graph_scan_scores_plain`), drop candidates already in
    the beam, and keep the top B of beam + candidates -- sorted as the
    kernel sorts (value descending, then id ascending with -1 last)."""
    scores, ids = graph_scan_scores_plain(q_scaled, q_lo, block_tags,
                                          row_ids, codes, nbr_rows,
                                          layout_block)
    beam_ids = beam_ids.to(torch.int32)
    present = torch.any(ids[:, :, None] == beam_ids[:, None, :], dim=2)
    scores = torch.where(present, torch.full_like(scores, NEG_INF), scores)
    ids = torch.where(present, torch.full_like(ids, -1), ids)
    all_v = torch.cat([beam_vals.to(torch.float32), scores], dim=1)
    all_i = torch.cat([beam_ids, ids], dim=1)
    key = torch.where(all_i >= 0, all_i.to(torch.int64),
                      torch.full_like(all_i, _ID_LAST, dtype=torch.int64))
    o = torch.sort(key, dim=1, stable=True).indices
    all_v, all_i = torch.gather(all_v, 1, o), torch.gather(all_i, 1, o)
    o = torch.sort(all_v, dim=1, descending=True,
                   stable=True).indices[:, :beam_vals.shape[1]]
    return torch.gather(all_v, 1, o), torch.gather(all_i, 1, o)


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "u8"):
        fn = getattr(lib, f"graph_scan_beam_step_{dt}")
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    lib.graph_scan_smem_bytes.argtypes = [i, i]
    lib.graph_scan_smem_bytes.restype = ctypes.c_longlong


def graph_scan_beam_step(q_scaled, q_lo, block_tags, row_ids, codes,
                         nbr_rows, beam_vals, beam_ids, layout_block: int,
                         tn: int = 8):
    """``q_scaled (M, C, d)`` f32, ``q_lo (M, C)`` f32, ``block_tags (NB,)``
    i32 (``NB = ceil(N / layout_block)``), ``row_ids (N,)`` i32, ``codes
    (N, d)`` u8 or f32, ``nbr_rows (M, S)`` i32 sorted-row indices (-1 =
    pad), ``beam_vals (M, B)`` f32 / ``beam_ids (M, B)`` i32 -> the merged
    beam ``(vals (M, B) f32, ids (M, B) i32)``, best first, ids ORIGINAL.

    ``tn`` is the reference's slab tile (rows per DMA on the TPU; its
    dispatcher shrinks it to ``layout_block`` when it does not divide it).
    The kernel here reads only the member rows, never slabs, so ``tn``
    changes nothing in the result; it stays for the reference's signature
    and for :func:`fresh_slab_count`.

    The kernel sorts the beam and the candidates together in one block's
    shared memory: any B with ``next_pow2(B + S) <= 16384`` (at ``S <=
    MAX_S``; a beam of up to 12,288 at S = 4096).

    CPU tensors take :func:`graph_scan_beam_step_plain`; CUDA tensors
    launch the kernel or raise."""
    from repro_torch import kernels as K
    args = dict(q_scaled=q_scaled, q_lo=q_lo, block_tags=block_tags,
                row_ids=row_ids, codes=codes, nbr_rows=nbr_rows,
                beam_vals=beam_vals, beam_ids=beam_ids)
    if tn <= 0:
        raise ValueError(f"graph_scan_beam_step needs tn > 0, got {tn}")
    if K.on_cpu(*args.values()):
        return graph_scan_beam_step_plain(q_scaled, q_lo, block_tags,
                                          row_ids, codes, nbr_rows,
                                          beam_vals, beam_ids, layout_block)
    K.check_cuda_inputs("graph_scan_beam_step", **args)
    if q_scaled.dtype != torch.float32 or q_lo.dtype != torch.float32 \
            or beam_vals.dtype != torch.float32 \
            or codes.dtype not in (torch.float32, torch.uint8) \
            or any(t.dtype != torch.int32
                   for t in (block_tags, row_ids, nbr_rows, beam_ids)):
        raise TypeError("graph_scan_beam_step takes f32 q_scaled/q_lo/"
                        "beam_vals, f32 or u8 codes and i32 block_tags/"
                        "row_ids/nbr_rows/beam_ids")
    m, c, d = q_scaled.shape
    n = codes.shape[0]
    if layout_block <= 0:
        raise ValueError("graph_scan_beam_step needs layout_block > 0")
    nb = -(-n // layout_block)
    if q_lo.shape != (m, c) or codes.shape != (n, d) \
            or block_tags.shape != (nb,) or row_ids.shape != (n,) \
            or nbr_rows.ndim != 2 or nbr_rows.shape[0] != m \
            or beam_vals.ndim != 2 or beam_vals.shape[0] != m \
            or beam_ids.shape != beam_vals.shape:
        raise ValueError("graph_scan_beam_step shapes do not agree")
    s, b = nbr_rows.shape[1], beam_vals.shape[1]
    if b < 1:
        raise ValueError(f"graph_scan_beam_step needs a beam of at least one "
                         f"slot, got {b}")
    if s > MAX_S:
        raise ValueError(f"graph_scan_beam_step takes at most {MAX_S} "
                         f"neighbor rows per query, got {s}")
    lib = K.load_library("graph_scan", _bind)
    if lib.graph_scan_smem_bytes(s, b) > SMEM_CAP:
        raise ValueError(f"graph_scan_beam_step: a beam of {b} and {s} "
                         "neighbor rows do not fit a block's shared memory "
                         "(B + S <= 16384)")
    dev = q_scaled.device
    vals = torch.empty((m, b), dtype=torch.float32, device=dev)
    ids = torch.empty((m, b), dtype=torch.int32, device=dev)
    if m == 0:
        return vals, ids
    dt = "f32" if codes.dtype == torch.float32 else "u8"
    err = getattr(lib, f"graph_scan_beam_step_{dt}")(
        q_scaled.data_ptr(), q_lo.data_ptr(), block_tags.data_ptr(),
        row_ids.data_ptr(), codes.data_ptr(), nbr_rows.data_ptr(),
        beam_vals.data_ptr(), beam_ids.data_ptr(), m, c, d, n, layout_block,
        s, b, vals.data_ptr(), ids.data_ptr(), K.current_stream(dev))
    K.check_launch("graph_scan_beam_step", err, lib)
    graph_scan_beam_step.launches += 1
    return vals, ids


graph_scan_beam_step.launches = 0


def beam_step_bytes(m: int, slabs_visited: float, tn: int, d: int, c: int,
                    beam: int, s: int, code_bytes: int = 1) -> float:
    """Device-memory bytes the TPU beam-step kernel moves for one hop of one
    query batch (the reference's traffic model, as arithmetic): per fresh
    slab ``tn * (d * code_bytes + 4) + 4``; per query ``C * d * 4 + C * 4``
    of prepared views, ``3 * S * 4`` of schedule and neighbor rows and
    ``4 * B * 8`` of beam in and out. ``slabs_visited`` counts the FRESH
    schedule entries across the batch (:func:`fresh_slab_count`)."""
    per_slab = tn * (d * code_bytes + 4) + 4
    per_query = c * d * 4 + c * 4 + 3 * s * 4 + 4 * beam * 8
    return float(m * per_query + slabs_visited * per_slab)


def fresh_slab_count(nbr_rows, tn: int) -> int:
    """Total fresh ``tn``-row slabs a hop with these neighbor rows reads on
    the TPU (host-side: the data-dependent term of
    :func:`beam_step_bytes`)."""
    rows = np.asarray(nbr_rows.cpu() if torch.is_tensor(nbr_rows)
                      else nbr_rows)
    total = 0
    for r in rows:
        v = r[r >= 0]
        total += int(np.unique(v // tn).size)
    return total
