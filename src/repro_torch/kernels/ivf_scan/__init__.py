"""Fused sorted-IVF range scan + top-k (the gather-free IVF fine step):
CUDA kernel (``csrc/ivf_scan.cu``), its plain PyTorch version, the
kernel's work plan in Python, the wrapper, and the kernel's traffic model.

Port of ``repro/kernels/ivf_scan`` (TPU kernel ``ivf_scan_topk``, body
``_range_scan_kernel``; oracles ``ivf_scan_topk_ref`` /
``ivf_scan_scores_ref``). ``sched (M, S)`` lists the layout blocks each
query visits (-1 = pad slot); every valid slot's single-tag slab is scored

    score[m, n] = <q_scaled[m, tag_b], codes_n> + q_lo[m, tag_b]

and the top k per query come out with ids from ``row_ids`` (-1 rows never
win; -inf winners carry id -1). Block indices outside [0, NB) count as pad
slots; a block listed twice is scored twice, as in the reference.

The kernel scans RUNS (:func:`schedule_runs`): a run is a maximal sequence
of a query's valid slots s, s + 1, ... whose blocks are consecutive and
carry one tag -- on the main path, each probed cluster's list. The runs
that start at one block are scanned together, each query keeping one
running top-k list for its run, or for each piece of it when long runs
are cut to balance the card (:func:`run_plan` mirrors the device's plan).
Any ``layout_block`` works.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.index.topk import NEG_INF

__all__ = ["ivf_scan_topk", "ivf_scan_topk_plain", "schedule_runs",
           "run_plan", "fold_profile", "fine_step_bytes"]

PIECES_PER_SM = 4       # work items an SM the plan aims at (ivf_scan.cu)
SIZE_BINS = 1024        # piece sizes the plan's largest-first sort tells apart

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


class Runs(NamedTuple):
    """The runs of a schedule, in (query, slot) order: run r is query
    ``query[r]``'s, starts at schedule slot ``slot[r]`` and layout block
    ``first[r]``, and covers ``blocks[r]`` consecutive blocks of tag
    ``tag[r]`` (the first block's ``block_tags`` entry)."""
    query: torch.Tensor
    slot: torch.Tensor
    first: torch.Tensor
    blocks: torch.Tensor
    tag: torch.Tensor


def schedule_runs(sched, block_tags) -> Runs:
    """The runs of ``sched (M, S)`` over layout blocks tagged ``block_tags
    (NB,)``: slot s continues slot s - 1's run when both are valid (in [0,
    NB)), ``sched[s] == sched[s - 1] + 1`` and the two blocks' tags are
    equal; every other valid slot starts a run (``ivf_runs_kernel``)."""
    m, s = sched.shape
    nb = block_tags.shape[0]
    dev = sched.device
    valid = (sched >= 0) & (sched < nb)
    b = torch.where(valid, sched, torch.zeros_like(sched)).long()
    tag = block_tags.long()[b] if nb else torch.zeros_like(b)
    cont = torch.zeros_like(valid)
    cont[:, 1:] = valid[:, 1:] & valid[:, :-1] & (b[:, 1:] == b[:, :-1] + 1) \
        & (tag[:, 1:] == tag[:, :-1])
    start = (valid & ~cont).reshape(-1)
    run_of = torch.cumsum(start.to(torch.int64), 0) - 1
    n_runs = int(start.sum())
    blocks = torch.zeros(n_runs, dtype=torch.int64, device=dev).index_add_(
        0, run_of[valid.reshape(-1)],
        torch.ones(int(valid.sum()), dtype=torch.int64, device=dev))
    pos = torch.nonzero(start).squeeze(1)
    return Runs(pos // max(s, 1), pos % max(s, 1), b.reshape(-1)[pos], blocks,
                tag.reshape(-1)[pos])


class RunPlan(NamedTuple):
    """The scan's work plan (``ivf_runs`` / ``ivf_plan`` /
    ``ivf_scatter_kernel``): the runs; per first block b0, the runs that
    start there (``group_count``), the blocks of the longest
    (``group_blocks``) and the pieces they are cut into (``group_pieces``:
    piece j covers blocks [nbk j / np, nbk (j + 1) / np) of b0's longest
    run, ``piece_blocks`` blocks a piece at most, about); the work items
    ``(b0, first run, runs, piece)`` (runs of one b0 in (query, slot)
    order, <= ``K.IP_TILE_M`` an item), largest piece first; each run's
    first partial slot ``run_slot`` and each query's slots ``nslots``."""
    runs: Runs
    group_count: torch.Tensor
    group_blocks: torch.Tensor
    group_pieces: torch.Tensor
    piece_blocks: int
    items: list
    run_slot: torch.Tensor
    nslots: torch.Tensor


def run_plan(sched, block_tags, layout_block: int, n_rows: int,
             sms: int) -> RunPlan:
    """The device plan of one ``ivf_scan_topk`` call on a card with ``sms``
    SMs, in Python (host tensors): the run groups by first block, the
    piece size that gives about ``PIECES_PER_SM`` items an SM (doubled
    until the items fit the kernel's workspace), the items, and the
    partial slots. A run of nq blocks is in the pieces whose first block
    lies below nq, ceil(nq np / nbk) <= nq of them, so a query's slots are
    at most its valid schedule slots: the kernel's (M, S, k) partial lists
    and (M, 2 S) floors are sized by the schedule alone. The items' order
    within one piece size is the device's atomics' (any order is
    correct)."""
    from repro_torch import kernels as K
    m, s = sched.shape
    nb = block_tags.shape[0]
    runs = schedule_runs(sched, block_tags)
    tm = K.IP_TILE_M
    count = torch.bincount(runs.first, minlength=nb)[:nb]
    longest = torch.zeros(nb, dtype=torch.int64).scatter_reduce_(
        0, runs.first, runs.blocks, "amax")
    groups = torch.nonzero(count).squeeze(1).tolist()
    chunks = {g: -(-int(count[g]) // tm) for g in groups}
    nbk = {g: int(longest[g]) for g in groups}
    work = sum(chunks[g] * (min((g + nbk[g]) * layout_block, n_rows)
                            - g * layout_block) for g in groups)
    top = max(nbk.values(), default=1)
    per_item = PIECES_PER_SM * sms * layout_block
    pb = max(1, min(top, -(-work // per_item)))
    w_max = m * s // tm + 1 + min(m * s, nb) + 4 * PIECES_PER_SM * sms
    while True:
        n_items = sum(chunks[g] * -(-nbk[g] // pb) for g in groups)
        if n_items <= w_max or pb >= top:
            break
        pb = min(2 * pb, top)
    pieces = torch.ones(nb, dtype=torch.int64)
    for g in groups:
        pieces[g] = -(-nbk[g] // pb)
    order = torch.argsort(runs.first, stable=True)   # (query, slot) order
    first_run = torch.cumsum(count, 0) - count
    items = []
    for g in groups:
        npc = int(pieces[g])
        for j in range(npc):
            size = nbk[g] * (j + 1) // npc - nbk[g] * j // npc
            for i in range(chunks[g]):
                cnt = min(tm, int(count[g]) - i * tm)
                items.append((min(size, SIZE_BINS - 1), g,
                              int(first_run[g]) + i * tm, cnt, j))
    items.sort(key=lambda it: -it[0])                 # stable: largest first
    items = [(g, order[e0:e0 + cnt], j) for _, g, e0, cnt, j in items]
    gb = torch.where(count > 0, longest, torch.ones_like(longest))
    per_run = -(-(runs.blocks * pieces[runs.first]) // gb[runs.first])
    run_slot = torch.zeros_like(per_run)
    nslots = torch.zeros(m, dtype=torch.int64)
    for r in range(per_run.numel()):                  # schedule order
        q = int(runs.query[r])
        run_slot[r] = nslots[q]
        nslots[q] += per_run[r]
    return RunPlan(runs, count, longest, pieces, pb, items, run_slot, nslots)


def ivf_scan_topk_plain(q_scaled, q_lo, block_tags, row_ids, codes, sched,
                        k: int, layout_block: int):
    """The kernel's function in plain PyTorch, organised as the kernel is:
    the runs of the schedule (:func:`schedule_runs`), grouped by their
    first block; one product per group over its longest run's rows against
    all its queries, each query's scores cut at its own run's end; one
    top-k per (query, run); then the merge of each query's run lists. Peak
    memory is one group's (runs, rows) scores plus the (M, runs, k)
    partials -- never the reference oracle's (M, S * L, d) gather."""
    m = sched.shape[0]
    dev = q_scaled.device
    n = codes.shape[0]
    c = q_scaled.shape[1]
    runs = schedule_runs(sched, block_tags)
    per_query = torch.bincount(runs.query, minlength=m)[:m]
    width = max(int(per_query.max()) if m else 0, 1)
    rank = torch.arange(runs.query.numel(), device=dev) \
        - (torch.cumsum(per_query, 0) - per_query)[runs.query]
    pv = torch.full((m, width, k), NEG_INF, dtype=torch.float32, device=dev)
    pi = torch.full((m, width, k), -1, dtype=torch.int32, device=dev)
    order = torch.argsort(runs.first, stable=True)
    firsts, counts = torch.unique_consecutive(runs.first[order],
                                              return_counts=True)
    start = 0
    for b, cnt in zip(firsts.tolist(), counts.tolist()):
        sel = order[start:start + cnt]
        start += cnt
        qm, nq = runs.query[sel], runs.blocks[sel]
        r0 = b * layout_block
        r1 = min(r0 + int(nq.max()) * layout_block, n)
        view = min(max(int(runs.tag[sel[0]]), 0), c - 1)
        rows = codes[r0:r1].to(torch.float32)
        scores = q_scaled[qm, view].to(torch.float32) @ rows.T \
            + q_lo[qm, view].to(torch.float32)[:, None]
        rid = row_ids[r0:r1].to(torch.int32)
        ends = torch.clamp(r0 + nq * layout_block, max=n) - r0
        ok = (rid >= 0)[None, :] \
            & (torch.arange(r1 - r0, device=dev)[None, :] < ends[:, None])
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
        ids = torch.where(ok, rid.expand(cnt, -1),
                          torch.full((cnt, r1 - r0), -1, dtype=torch.int32,
                                     device=dev))
        if r1 - r0 < k:
            pad = k - (r1 - r0)
            scores = torch.cat([scores, torch.full((cnt, pad), NEG_INF,
                                                   device=dev)], dim=1)
            ids = torch.cat([ids, torch.full((cnt, pad), -1,
                                             dtype=torch.int32, device=dev)],
                            dim=1)
        v, i = _best_first(scores, ids, k)
        pv[qm, rank[sel]] = v
        pi[qm, rank[sel]] = i
    vals, ids = _best_first(pv.reshape(m, width * k),
                            pi.reshape(m, width * k), k)
    return vals, torch.where(vals > NEG_INF, ids, torch.full_like(ids, -1))


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in ("f32", "u8"):
        fn = getattr(lib, f"ivf_scan_topk_{dt}")
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    lib.ivf_scan_profile.argtypes = [p, p, p, p, p, i, p, i, i, i, i, i, i, i,
                                     i, i, p, p, p]
    lib.ivf_scan_profile.restype = ctypes.c_int
    lib.ivf_scan_workspace_bytes.argtypes = [i, i, i, i, i]
    lib.ivf_scan_workspace_bytes.restype = ctypes.c_longlong


def _checked(q_scaled, q_lo, block_tags, row_ids, codes, sched, k: int,
             layout_block: int):
    """Check a call on CUDA tensors; returns (m, c, d, n, nb, s, sms)."""
    from repro_torch import kernels as K
    K.check_cuda_inputs("ivf_scan_topk", q_scaled=q_scaled, q_lo=q_lo,
                        block_tags=block_tags, row_ids=row_ids, codes=codes,
                        sched=sched)
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
    sms = torch.cuda.get_device_properties(q_scaled.device) \
        .multi_processor_count
    return m, c, d, n, nb, sched.shape[1], sms


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
    if K.on_cpu(q_scaled, q_lo, block_tags, row_ids, codes, sched):
        return ivf_scan_topk_plain(q_scaled, q_lo, block_tags, row_ids,
                                   codes, sched, k, layout_block)
    m, c, d, n, nb, s, sms = _checked(q_scaled, q_lo, block_tags, row_ids,
                                      codes, sched, k, layout_block)
    dev = q_scaled.device
    vals = torch.empty((m, k), dtype=torch.float32, device=dev)
    ids = torch.empty((m, k), dtype=torch.int32, device=dev)
    if m == 0:
        return vals, ids
    lib = K.load_library("ivf_scan", _bind)
    ws = torch.empty(lib.ivf_scan_workspace_bytes(m, s, nb, k, sms),
                     dtype=torch.uint8, device=dev)
    dt = "f32" if codes.dtype == torch.float32 else "u8"
    err = getattr(lib, f"ivf_scan_topk_{dt}")(
        q_scaled.data_ptr(), q_lo.data_ptr(), block_tags.data_ptr(),
        row_ids.data_ptr(), codes.data_ptr(), sched.data_ptr(), m, c, d, n,
        nb, layout_block, s, k, sms, ws.data_ptr(), vals.data_ptr(),
        ids.data_ptr(), K.current_stream(dev))
    K.check_launch("ivf_scan_topk", err, lib)
    K.count_launch(ivf_scan_topk)
    return vals, ids


ivf_scan_topk.launches = 0

FOLD_PARTS = ("kernel", "fold", "append", "wait", "insert", "vote")


def fold_profile(q_scaled, q_lo, block_tags, row_ids, codes, sched, k: int,
                 layout_block: int) -> dict:
    """The plan and one pass of the kernel's scan on CUDA tensors (1 <= k
    <= ``K.PASS_K``, no merge) with its fold profiled: {part: cycles} of
    ``FOLD_PARTS``, thread 0's ``clock64`` summed over the blocks, as
    ``ip_topk.fold_profile`` reads it. For timing only: not counted in
    ``ivf_scan_topk.launches``."""
    from repro_torch import kernels as K
    m, c, d, n, nb, s, sms = _checked(q_scaled, q_lo, block_tags, row_ids,
                                      codes, sched, k, layout_block)
    if not 1 <= k <= K.PASS_K:
        raise ValueError(f"one scan pass takes 1 <= k <= {K.PASS_K}")
    lib = K.load_library("ivf_scan", _bind)
    dev = q_scaled.device
    ws = torch.empty(lib.ivf_scan_workspace_bytes(m, s, nb, k, sms),
                     dtype=torch.uint8, device=dev)
    clocks = torch.zeros(len(FOLD_PARTS), dtype=torch.int64, device=dev)
    if m > 0:
        err = lib.ivf_scan_profile(
            q_scaled.data_ptr(), q_lo.data_ptr(), block_tags.data_ptr(),
            row_ids.data_ptr(), codes.data_ptr(),
            int(codes.dtype == torch.uint8), sched.data_ptr(), m, c, d, n, nb,
            layout_block, s, k, sms, ws.data_ptr(), clocks.data_ptr(),
            K.current_stream(dev))
        K.check_launch("ivf_scan_topk profile", err, lib)
    return dict(zip(FOLD_PARTS, clocks.tolist()))


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
