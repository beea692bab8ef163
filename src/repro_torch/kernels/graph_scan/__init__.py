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

``graph_beam_search`` (same source) runs the whole fused traversal in one
launch, one block a query from its entry beam to its last hop, each hop
the body above: the reference's ``while_loop`` (``repro/index/graph.py``),
with no host sync and no torch op between hops. Its plain version,
:func:`graph_beam_search_plain`, is the kernel's algorithm over
:func:`graph_scan_beam_step_plain`'s merge.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.index.topk import NEG_INF

__all__ = ["graph_scan_beam_step", "graph_scan_beam_step_plain",
           "graph_scan_scores_plain", "graph_beam_search",
           "graph_beam_search_plain", "search_profile", "SEARCH_PARTS",
           "beam_step_bytes", "fresh_slab_count", "MAX_S"]

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


def _merge_plain(scores, ids, beam_vals, beam_ids, beam_pay=None):
    """Drop the candidates ``(scores, ids)`` already in the beam and keep
    the top B of beam + candidates, sorted as the kernel sorts (value
    descending, then id ascending with -1 last). ``beam_pay``: a payload
    per beam slot carried with its entry (0 for a candidate)."""
    beam_ids = beam_ids.to(torch.int32)
    present = torch.any(ids[:, :, None] == beam_ids[:, None, :], dim=2)
    scores = torch.where(present, torch.full_like(scores, NEG_INF), scores)
    ids = torch.where(present, torch.full_like(ids, -1), ids)
    all_v = torch.cat([beam_vals.to(torch.float32), scores], dim=1)
    all_i = torch.cat([beam_ids, ids], dim=1)
    key = torch.where(all_i >= 0, all_i.to(torch.int64),
                      torch.full_like(all_i, _ID_LAST, dtype=torch.int64))
    o = torch.sort(key, dim=1, stable=True).indices
    o = torch.gather(o, 1, torch.sort(torch.gather(all_v, 1, o), dim=1,
                                      descending=True, stable=True).indices)
    o = o[:, :beam_vals.shape[1]]
    out = (torch.gather(all_v, 1, o), torch.gather(all_i, 1, o))
    if beam_pay is None:
        return out
    all_p = torch.cat([beam_pay, torch.zeros_like(scores,
                                                  dtype=beam_pay.dtype)], 1)
    return out + (torch.gather(all_p, 1, o),)


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
    return _merge_plain(scores, ids, beam_vals, beam_ids)


def graph_beam_search_plain(q_scaled, q_lo, block_tags, row_ids, codes,
                            nbr_tbl, beam_vals, beam_ids, layout_block: int,
                            max_hops: int, expand: int):
    """The kernel's traversal in plain PyTorch, every query on its own:
    the entry beam ordered by (value descending, slot); then per hop, for
    each query that still has an expandable slot (unvisited, id >= 0):
    pick the first ``expand`` of (expandable slots scoring above NEG_INF,
    then every other slot), each group in slot order -- the batched
    loop's stable best-first pick on a beam sorted best first -- mark them
    visited (expand 1: on the query's work, as the loop), read their rows
    of ``nbr_tbl`` (-1 ids read vertex 0, as the loop) and merge as
    :func:`graph_scan_beam_step_plain`, the visited flags carried with
    their entries. A query that has no expandable slot stops; the others
    go on to ``max_hops``. Returns (vals (M, B), ids (M, B), hops (M,)
    int32): each query's beam best first and its hop count (``max_hops
    == 0``: the entry beam as given)."""
    m, b = beam_vals.shape
    e = max(1, expand)
    dev = beam_vals.device
    if max_hops <= 0:
        return (beam_vals.clone(), beam_ids.clone(),
                torch.zeros((m,), dtype=torch.int32, device=dev))
    o = torch.sort(beam_vals.to(torch.float32), dim=1, descending=True,
                   stable=True).indices
    vals = torch.gather(beam_vals.to(torch.float32), 1, o)
    ids = torch.gather(beam_ids.to(torch.int32), 1, o)
    vis = torch.zeros((m, b), dtype=torch.int32, device=dev)
    hops = torch.zeros((m,), dtype=torch.int32, device=dev)
    slot = torch.arange(b, device=dev)
    r = nbr_tbl.shape[1]
    for _ in range(max_hops):
        x = (ids >= 0) & (vis == 0)
        active = x.any(dim=1)
        if not bool(active.any()):
            break
        first = x & (vals > NEG_INF)
        best = torch.sort(torch.where(first, slot, slot + b), dim=1).indices[
            :, :e]
        sel_ok = (active[:, None].expand(m, e) if e == 1
                  else torch.gather(x, 1, best))
        vis = vis.scatter(1, best, torch.gather(vis, 1, best)
                          | sel_ok.to(torch.int32))
        vid = torch.gather(ids, 1, best).clamp(min=0).long()
        rows = nbr_tbl[vid.clamp(max=nbr_tbl.shape[0] - 1)]
        rows = torch.where((rows >= 0) & sel_ok[:, :, None]
                           & (vid < nbr_tbl.shape[0])[:, :, None], rows,
                           torch.full_like(rows, -1)).reshape(m, e * r)
        scores, cids = graph_scan_scores_plain(q_scaled, q_lo, block_tags,
                                               row_ids, codes, rows,
                                               layout_block)
        nv, ni, nvis = _merge_plain(scores, cids, vals, ids, vis)
        keep = active[:, None]
        vals = torch.where(keep, nv, vals)
        ids = torch.where(keep, ni, ids)
        vis = torch.where(keep, nvis, vis)
        hops += active.to(torch.int32)
    return vals, ids, hops


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "u8"):
        fn = getattr(lib, f"graph_scan_beam_step_{dt}")
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    lib.graph_scan_smem_bytes.argtypes = [i, i]
    lib.graph_scan_smem_bytes.restype = ctypes.c_longlong
    for dt in ("f32", "u8"):
        fn = getattr(lib, f"graph_beam_search_{dt}")
        fn.argtypes = [p, p, p, p, p, p, i, i, p, p, i, i, i, i, i, i, i, i,
                       p, p, p, p]
        fn.restype = ctypes.c_int
    lib.graph_search_smem_bytes.argtypes = [i, i, i]
    lib.graph_search_smem_bytes.restype = ctypes.c_longlong
    lib.graph_beam_search_profile.argtypes = [p, p, p, p, p, i, p, i, i, p,
                                              p, i, i, i, i, i, i, i, i, p,
                                              p, p, p, p]
    lib.graph_beam_search_profile.restype = ctypes.c_int


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
    K.count_launch(graph_scan_beam_step)
    return vals, ids


graph_scan_beam_step.launches = 0


def graph_beam_search(q_scaled, q_lo, block_tags, row_ids, codes, nbr_tbl,
                      beam_vals, beam_ids, layout_block: int, max_hops: int,
                      expand: int):
    """The whole fused traversal in one launch. ``q_scaled``, ``q_lo``,
    ``block_tags``, ``row_ids`` and ``codes`` as
    :func:`graph_scan_beam_step`; ``nbr_tbl (n, R)`` i32 every vertex's
    neighbors as sorted rows (-1 = none; ``GraphIndex.nbr_rows``);
    ``beam_vals (M, B)`` f32 / ``beam_ids (M, B)`` i32 the scored entry
    beam in slot order -> ``(vals (M, B) f32, ids (M, B) i32, hops (M,)
    i32)``: each query's beam best first, ids ORIGINAL, and its hop count
    (the batch's is the maximum). ``expand`` slots a hop, at most
    ``max_hops`` hops.

    One block a query: any B and ``S = expand * R <= MAX_S`` whose beam,
    visited flags and hop rows fit a block's shared memory (the library's
    ``graph_search_smem_bytes``; any ``B + S <= 8192`` does).
    ``max_hops == 0`` launches nothing and returns the entry beam as given,
    with zero hops.

    CPU tensors take :func:`graph_beam_search_plain`; CUDA tensors launch
    the kernel or raise."""
    from repro_torch import kernels as K
    e = _search_expand(beam_vals, max_hops, expand)
    if K.on_cpu(q_scaled, q_lo, block_tags, row_ids, codes, nbr_tbl,
                beam_vals, beam_ids):
        return graph_beam_search_plain(q_scaled, q_lo, block_tags, row_ids,
                                       codes, nbr_tbl, beam_vals, beam_ids,
                                       layout_block, max_hops, e)
    out = _search_launch(q_scaled, q_lo, block_tags, row_ids, codes, nbr_tbl,
                         beam_vals, beam_ids, layout_block, max_hops, e)
    if max_hops > 0 and beam_vals.shape[0] > 0:
        K.count_launch(graph_beam_search)
    return out[:3]


SEARCH_PARTS = ("pick", "rows", "filter", "score", "merge", "kernel")


def search_profile(q_scaled, q_lo, block_tags, row_ids, codes, nbr_tbl,
                   beam_vals, beam_ids, layout_block: int, max_hops: int,
                   expand: int) -> dict:
    """:func:`graph_beam_search` on CUDA tensors with its hops profiled:
    {part: cycles} of ``SEARCH_PARTS`` -- the pick, the rows' table reads,
    the filter (hash set, ids and tags, beam test, list), the scoring, the
    merge, and the whole kernel -- thread 0's ``clock64`` summed over the
    blocks (each part ends at a barrier, so it holds the wait for the
    block's slowest warp). For timing only: not counted in
    ``graph_beam_search.launches``."""
    e = _search_expand(beam_vals, max_hops, expand)
    clocks = _search_launch(q_scaled, q_lo, block_tags, row_ids, codes,
                            nbr_tbl, beam_vals, beam_ids, layout_block,
                            max_hops, e, profile=True)[3]
    return dict(zip(SEARCH_PARTS, clocks.tolist()))


def _search_expand(beam_vals, max_hops: int, expand: int) -> int:
    e = max(1, expand)
    if max_hops < 0:
        raise ValueError(f"graph_beam_search needs max_hops >= 0, got "
                         f"{max_hops}")
    if beam_vals.ndim != 2 or e > beam_vals.shape[1]:
        raise ValueError(f"graph_beam_search: expand {e} must not exceed "
                         f"the beam width {beam_vals.shape[-1]}")
    return e


def _search_launch(q_scaled, q_lo, block_tags, row_ids, codes, nbr_tbl,
                   beam_vals, beam_ids, layout_block: int, max_hops: int,
                   e: int, profile: bool = False):
    """Check the CUDA inputs and launch the traversal (``profile``: its
    profiled instantiation): (vals, ids, hops, clocks or None)."""
    from repro_torch import kernels as K
    args = dict(q_scaled=q_scaled, q_lo=q_lo, block_tags=block_tags,
                row_ids=row_ids, codes=codes, nbr_tbl=nbr_tbl,
                beam_vals=beam_vals, beam_ids=beam_ids)
    K.check_cuda_inputs("graph_beam_search", **args)
    if q_scaled.dtype != torch.float32 or q_lo.dtype != torch.float32 \
            or beam_vals.dtype != torch.float32 \
            or codes.dtype not in (torch.float32, torch.uint8) \
            or any(t.dtype != torch.int32
                   for t in (block_tags, row_ids, nbr_tbl, beam_ids)):
        raise TypeError("graph_beam_search takes f32 q_scaled/q_lo/"
                        "beam_vals, f32 or u8 codes and i32 block_tags/"
                        "row_ids/nbr_tbl/beam_ids")
    m, c, d = q_scaled.shape
    n = codes.shape[0]
    if layout_block <= 0:
        raise ValueError("graph_beam_search needs layout_block > 0")
    nb = -(-n // layout_block)
    if q_lo.shape != (m, c) or codes.shape != (n, d) \
            or block_tags.shape != (nb,) or row_ids.shape != (n,) \
            or nbr_tbl.ndim != 2 or beam_vals.shape[0] != m \
            or beam_ids.shape != beam_vals.shape:
        raise ValueError("graph_beam_search shapes do not agree")
    b, r = beam_vals.shape[1], nbr_tbl.shape[1]
    if e * r > MAX_S:
        raise ValueError(f"graph_beam_search takes at most {MAX_S} neighbor "
                         f"rows a hop, got expand {e} x degree {r}")
    dev = q_scaled.device
    clocks = (torch.zeros(len(SEARCH_PARTS), dtype=torch.int64, device=dev)
              if profile else None)
    if max_hops == 0 or m == 0:
        return (beam_vals.clone(), beam_ids.clone(),
                torch.zeros((m,), dtype=torch.int32, device=dev), clocks)
    lib = K.load_library("graph_scan", _bind)
    if lib.graph_search_smem_bytes(e * r, b, e) > SMEM_CAP:
        raise ValueError(f"graph_beam_search: a beam of {b} and {e * r} "
                         "neighbor rows do not fit a block's shared memory")
    vals = torch.empty((m, b), dtype=torch.float32, device=dev)
    ids = torch.empty((m, b), dtype=torch.int32, device=dev)
    hops = torch.empty((m,), dtype=torch.int32, device=dev)
    ptrs = (q_scaled.data_ptr(), q_lo.data_ptr(), block_tags.data_ptr(),
            row_ids.data_ptr(), codes.data_ptr())
    tail = (nbr_tbl.data_ptr(), nbr_tbl.shape[0], r, beam_vals.data_ptr(),
            beam_ids.data_ptr(), m, c, d, n, layout_block, b, e, max_hops,
            vals.data_ptr(), ids.data_ptr(), hops.data_ptr())
    if profile:
        err = lib.graph_beam_search_profile(
            *ptrs, int(codes.dtype == torch.uint8), *tail, clocks.data_ptr(),
            K.current_stream(dev))
    else:
        dt = "f32" if codes.dtype == torch.float32 else "u8"
        err = getattr(lib, f"graph_beam_search_{dt}")(*ptrs, *tail,
                                                      K.current_stream(dev))
    K.check_launch("graph_beam_search", err, lib)
    return vals, ids, hops, clocks


graph_beam_search.launches = 0


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
