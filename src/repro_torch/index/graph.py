"""Vamana-style graph index (port of ``repro/index/graph.py``): numpy
NN-descent + RobustPrune build (offline), a CAGRA-style device build, and a
batched best-first beam search.

The beams of a whole query batch advance in lockstep; each hop pops the
top-``expand`` unvisited frontier vertices per query (``expand=1`` is the
classic best-first loop) and scores their (batch, expand * R) neighbors.
The scoring goes through the scorer protocol (``score_ids``), so the same
traversal serves every scorer mode; graph edges hold ORIGINAL ids.

One launch: every search of a batch whose scorer has a lowering runs as
one ``graph_beam_search`` launch (``kernels.scorer_beam_search``): one
block a query keeps its beam on the chip from the entry points to its last
hop, with no host sync and no torch op between hops. The four gathered
scorers hop through the graph's id table as rows of their own store
(layout block 1; a removed id's row reads -1); a tag-sorted scorer hops
through a fused graph's ``nbr_rows`` -- its edge lists translated into the
scorer's SORTED-ROW space (:func:`with_fused_scan`). ``nbr_rows`` is bound
to the layout's slot assignment: re-derive it (``refreshed``,
:func:`with_fused_scan`) after slot churn, since an insert after a remove
may reuse a freed slot.

Figure 7's tag trace, and a scorer without a lowering, run the reference's
``jax.lax.while_loop`` as a Python loop (``_beam_loop``) whose condition,
``hop < max_hops and any(expandable)``, reads one flag from the device per
hop (a host sync per hop): its hops are the gathered merge
(:func:`gathered_beam_step`, the reference's own semantics) or, on a fused
graph, ``scan_neighbors`` (:func:`fused_hop_step`, one
``graph_scan_beam_step`` launch a hop).

Streamed growth: :func:`with_capacity` pads the edge table and
:func:`insert_ids` links new rows (a sequential host loop, as the
reference). Sharded: each shard's graph is built over its own rows (local
ids, -1-padded entries when stacked) and ``globalize_ids`` lifts its ids
by the shard's row offset (:mod:`repro_torch.index.distributed`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import rerank_tier, spherical_kmeans
from repro_torch.core.scorer import GleanVecScorer, LinearScorer
from repro_torch.device import resolve_device
from repro_torch.index.protocol import _offset_ids
from repro_torch.index.topk import NEG_INF

__all__ = ["GraphIndex", "build", "build_device", "with_fused_scan",
           "with_capacity", "insert_ids", "beam_search_scorer",
           "beam_search", "beam_search_gleanvec", "beam_search_traced",
           "gathered_beam_step", "fused_hop_step"]

# build(method="auto") switches from numpy NN-descent to the device build at
# this many rows.
_DEVICE_BUILD_MIN_N = 8192

# Elements of one chunk's (b, k0, k0, k0) compare in _detour_mask: the
# reference's 2**24 on the CPU (sized for TPU memory there), 2**29 on a GPU
# (about 4,900 nodes a chunk at k0 = 48, ~0.5 GB of bools). The mask does
# not depend on the chunk.
_DETOUR_CHUNK_ELEMS = {"cpu": 2 ** 24, "cuda": 2 ** 29}


@dataclass(frozen=True, eq=False)
class GraphIndex:
    """Navigable graph implementing the Index protocol. ``beam`` /
    ``max_hops`` / ``expand`` are the search configuration of the protocol
    path (``candidates``); the explicit entry points take overrides.
    Entries may be -1-padded: padded slots never enter the beam.

    ``nbr_rows`` + ``fused`` enable the gather-free traversal: ``nbr_rows``
    is ``neighbors`` translated into a tag-sorted scorer's sorted-row space
    (:func:`with_fused_scan`; removed ids -> -1), and ``candidates`` then
    runs the search as one ``graph_beam_search`` launch whenever the scorer
    has ``scan_neighbors``. ``scan_tn`` is the reference kernel's slab
    tile."""

    neighbors: torch.Tensor                 # (n, R) int32, -1 padded
    entries: torch.Tensor                   # (E,) int32 entry points
    nbr_rows: Optional[torch.Tensor] = None  # (n, R) int32 sorted rows
    beam: int = 64
    max_hops: int = 256
    expand: int = 1       # frontier vertices expanded per hop
    fused: bool = False   # gather-free traversal (scorer.scan_neighbors)
    scan_tn: int = 8      # graph_scan slab tile of the reference

    # ---- Index protocol ----------------------------------------------------

    def prepare_queries(self, scorer, queries):
        return scorer.prepare_queries(queries)

    def candidates(self, qstate, scorer, k: int):
        top, ids, _, _ = _beam_qstate(qstate, scorer, self, k, self.beam,
                                      self.max_hops, expand=self.expand)
        # -inf winners are unfilled beam slots (or dead rows a scorer
        # masked); strip their ids like the IVF path does.
        return top, torch.where(top > NEG_INF, ids, torch.full_like(ids, -1))

    def search(self, queries, scorer, k: int):
        return self.candidates(self.prepare_queries(scorer, queries),
                               scorer, k)

    def globalize_ids(self, scorer, ids, row_start):
        return _offset_ids(ids, row_start)

    def refreshed(self, scorer, model) -> "GraphIndex":
        """Streaming-refresh hook: the edges come from full-D geometry,
        which a refresh does not change, but the fused variant's
        ``nbr_rows`` binds edges to the scorer's slot assignment, so it is
        re-derived against the (possibly churned) layout here."""
        if self.fused and getattr(scorer, "inv_perm", None) is not None:
            return with_fused_scan(self, scorer, tn=self.scan_tn)
        return self


def with_fused_scan(index: GraphIndex, scorer, tn: int = 8) -> GraphIndex:
    """Layout-aware variant of ``index`` bound to a tag-sorted ``scorer``:
    edge lists translated through ``scorer.inv_perm`` into sorted-row
    space (removed ids -> -1), and ``candidates`` runs the gather-free
    traversal. Re-run (or let ``refreshed`` run it) after
    any slot churn."""
    inv = getattr(scorer, "inv_perm", None)
    if inv is None:
        raise ValueError("with_fused_scan needs a tag-sorted scorer "
                         "(SortedGleanVec*) with an inv_perm")
    nbrs = index.neighbors
    inv = inv.to(nbrs.device)
    ok = nbrs >= 0
    rows = inv[torch.where(ok, nbrs, torch.zeros_like(nbrs)).long()]
    rows = torch.where(ok & (rows >= 0), rows, torch.full_like(rows, -1))
    return dataclasses.replace(index, fused=True, scan_tn=tn,
                               nbr_rows=rows.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# Streamed growth: pre-allocated edge rows + incremental edge insertion.
# ---------------------------------------------------------------------------


def with_capacity(index: GraphIndex, capacity: int) -> GraphIndex:
    """Pad the edge table to ``capacity`` rows (edgeless, all -1) so a
    streamed graph can grow: :func:`insert_ids` fills a padded row's edges
    in place, keeping every shape -- the engine's swap contract. Size
    ``capacity`` to the streaming store's row capacity."""
    n, r = index.neighbors.shape
    if capacity < n:
        raise ValueError(f"capacity {capacity} < current rows {n}")
    if capacity == n:
        return index
    pad = torch.full((capacity - n, r), -1, dtype=index.neighbors.dtype,
                     device=index.neighbors.device)
    nbr_rows = index.nbr_rows
    if nbr_rows is not None:
        nbr_rows = torch.cat([nbr_rows, pad.to(nbr_rows.dtype)])
    return dataclasses.replace(
        index, neighbors=torch.cat([index.neighbors, pad]), nbr_rows=nbr_rows)


def insert_ids(index: GraphIndex, rows, ids, scorer, x_full,
               kappa: Optional[int] = None) -> GraphIndex:
    """Connect newly inserted external ``ids`` (full-D ``rows``) into the
    graph, in place of edgeless rows (see :func:`with_capacity`); the
    reference's Vamana-style insert, step for step:

    1. OUT-edges: beam-search the current graph for each new row's
       ``kappa`` candidates through the serving ``scorer``, add the
       batch-mates, re-rank the pool by full-D L2 distance against
       ``x_full`` (a device tensor or a host store: one gather of the
       candidate rows) and keep the R closest.
    2. REVERSE-edge fill: each new vertex v joins each out-neighbor t's
       list in a free slot, or replaces t's farthest edge when closer; if
       no target took it, its nearest target cedes its last slot.

    A sequential host loop whose result depends on the order (ported as it
    is). A fused index re-derives ``nbr_rows`` against the scorer's layout.
    Entries are untouched."""
    ids = np.asarray(ids.cpu() if torch.is_tensor(ids) else ids,
                     np.int64).reshape(-1)
    if ids.size == 0:
        return index
    dev = index.neighbors.device
    nbrs = index.neighbors.cpu().numpy().astype(np.int64)
    cap, r = nbrs.shape
    rows_np = np.asarray(rows.cpu() if torch.is_tensor(rows) else rows,
                         np.float32).reshape(ids.size, -1)
    if np.any(ids >= cap):
        raise ValueError("insert id beyond edge-table capacity; grow with "
                         "with_capacity first")
    kappa = kappa or max(2 * r, 16)

    def _fetch(ext_ids: np.ndarray) -> np.ndarray:
        # through the store's own gather on either tier (host or device)
        return rerank_tier.rows(x_full, np.asarray(ext_ids, np.int64),
                                "cpu").to(torch.float32).numpy()

    # 1) candidate pool: reduced-space beam search + batch-mates
    _, cand = beam_search_scorer(torch.as_tensor(rows_np, device=dev),
                                 scorer, index, k=kappa,
                                 beam=max(index.beam, kappa),
                                 max_hops=index.max_hops,
                                 expand=index.expand)
    cand = cand.cpu().numpy().astype(np.int64)              # (b, kappa)
    mates = np.broadcast_to(ids, (ids.size, ids.size))
    cand = np.concatenate([cand, mates], axis=1)
    cand[cand == ids[:, None]] = -1                         # no self loops
    # full-D L2 re-rank of each row's candidate pool
    cvecs = _fetch(np.where(cand >= 0, cand, 0))            # (b, K, D)
    d2 = np.sum((cvecs - rows_np[:, None, :]) ** 2, axis=2)
    d2[cand < 0] = np.inf
    # mask duplicate candidates (keep first) before taking the closest R
    for b in range(ids.size):
        _, first = np.unique(cand[b], return_index=True)
        dup = np.ones(cand.shape[1], bool)
        dup[first] = False
        d2[b, dup] = np.inf
    sel = np.argsort(d2, axis=1, kind="stable")[:, :r]
    out_edges = np.take_along_axis(cand, sel, axis=1)
    out_edges[np.take_along_axis(d2, sel, axis=1) == np.inf] = -1
    nbrs[ids] = out_edges

    # 2) reverse-edge fill with full-D distances + in-edge guarantee
    for b, v in enumerate(ids):
        placed = False
        targets = out_edges[b][out_edges[b] >= 0]
        t_vecs = _fetch(targets) if targets.size else None
        for j, t in enumerate(targets):
            row = nbrs[t]
            if v in row:
                placed = True
                continue
            free = np.nonzero(row < 0)[0]
            if free.size:
                nbrs[t, free[0]] = v
                placed = True
                continue
            d_edges = np.sum((_fetch(row) - t_vecs[j][None, :]) ** 2, axis=1)
            far = int(np.argmax(d_edges))
            d_v = float(np.sum((rows_np[b] - t_vecs[j]) ** 2))
            if d_v < d_edges[far]:
                nbrs[t, far] = v
                placed = True
        if not placed and targets.size:
            nbrs[targets[0], r - 1] = v     # nearest target cedes a slot

    # dedupe only the touched rows (insert slots + reverse-fill targets)
    touched = np.unique(np.concatenate(
        [ids, out_edges[out_edges >= 0].ravel()]))
    nbrs[touched] = _dedupe_rows(nbrs[touched])
    new = dataclasses.replace(
        index, neighbors=torch.as_tensor(nbrs.astype(np.int32), device=dev))
    if index.fused and getattr(scorer, "inv_perm", None) is not None:
        new = with_fused_scan(new, scorer, tn=index.scan_tn)
    return new


# ---------------------------------------------------------------------------
# Build (offline, numpy): NN-descent for candidates + RobustPrune for edges.
# The numpy helpers are copies of the reference's (same RNG draws, same
# results).
# ---------------------------------------------------------------------------


def _chunked_l2(x: np.ndarray, cand: np.ndarray, chunk: int = 2048):
    """d2[i, j] = ||x_i - x_cand[i, j]||^2, chunked over rows."""
    n, k = cand.shape
    out = np.empty((n, k), np.float32)
    x_sq = np.sum(x * x, axis=1)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        c = cand[s:e]
        diff_ip = np.einsum("bkd,bd->bk", x[c], x[s:e])
        out[s:e] = x_sq[c] - 2.0 * diff_ip + x_sq[s:e, None]
    return out


def _nn_descent(x: np.ndarray, r: int, n_iters: int, rng) -> np.ndarray:
    """Approximate 2R-NN lists via neighbor-of-neighbor refinement."""
    n = x.shape[0]
    k = 2 * r
    nbrs = rng.integers(0, n, size=(n, k), dtype=np.int64)
    self_ids = np.arange(n)[:, None]
    for _ in range(n_iters):
        # candidates = current + neighbors-of-neighbors (sampled) + random
        nn = nbrs[nbrs[:, rng.permutation(k)[: max(2, k // 4)]]]
        nn = nn.reshape(n, -1)
        rand = rng.integers(0, n, size=(n, r // 2), dtype=np.int64)
        cand = np.concatenate([nbrs, nn, rand], axis=1)
        # dedupe by sorting; keep first occurrence (stable unique per row)
        cand.sort(axis=1)
        dup = np.concatenate(
            [np.zeros((n, 1), bool), cand[:, 1:] == cand[:, :-1]], axis=1)
        d2 = _chunked_l2(x, cand)
        d2[dup] = np.inf
        d2[cand == self_ids] = np.inf
        sel = np.argpartition(d2, k - 1, axis=1)[:, :k]
        nbrs = np.take_along_axis(cand, sel, axis=1)
        row_d = np.take_along_axis(d2, sel, axis=1)
        order = np.argsort(row_d, axis=1)
        nbrs = np.take_along_axis(nbrs, order, axis=1)
    return nbrs


def _robust_prune(x: np.ndarray, cand: np.ndarray, r: int, alpha: float,
                  chunk: int = 1024) -> np.ndarray:
    """Vamana RobustPrune, vectorized over nodes (inner loop over K slots).
    ``cand`` (n, K) sorted by distance ascending. Keeps <= r diverse edges:
    a candidate c survives iff for every previously kept edge e,
    alpha * d(e, c) >= d(p, c)."""
    n, k = cand.shape
    out = np.full((n, r), -1, np.int64)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        c = cand[s:e]                        # (b, K) sorted by d(p, .)
        b = c.shape[0]
        vecs = x[c]                          # (b, K, D)
        sq = np.sum(vecs * vecs, axis=2)
        pair = sq[:, :, None] - 2 * np.einsum("bkd,bld->bkl", vecs, vecs) \
            + sq[:, None, :]
        d_p = np.sum((vecs - x[s:e][:, None, :]) ** 2, axis=2)  # (b, K)
        kept = np.zeros((b, k), bool)
        pruned = np.zeros((b, k), bool)
        n_kept = np.zeros(b, np.int32)
        for j in range(k):
            take = (~pruned[:, j]) & (n_kept < r)
            kept[:, j] = take
            n_kept += take
            # prune later candidates too close to j (relative to p)
            closer = alpha * pair[:, j, :] < d_p
            pruned |= closer & take[:, None]
        for row in range(b):
            ids = c[row][kept[row]][:r]
            out[s + row, : len(ids)] = ids
    return out


def _reverse_edge_fill_ref(nbrs: np.ndarray, r: int) -> np.ndarray:
    """Sequential reverse-edge fill, the parity oracle of
    :func:`_reverse_edge_fill`: for every forward edge dst -> src, append
    dst to src's list if a slot remains and the edge is neither a self-loop
    nor already present."""
    nbrs = nbrs.copy()
    n = nbrs.shape[0]
    slots = np.sum(nbrs >= 0, axis=1)
    rev_src = nbrs.ravel()
    rev_dst = np.repeat(np.arange(n), r)
    ok = rev_src >= 0
    for srcv, dstv in zip(rev_src[ok], rev_dst[ok]):
        s = slots[srcv]
        if s < r and dstv != srcv:
            row = nbrs[srcv]
            if dstv not in row[:s]:
                nbrs[srcv, s] = dstv
                slots[srcv] += 1
    return nbrs


def _reverse_edge_fill(nbrs: np.ndarray, r: int) -> np.ndarray:
    """Vectorized reverse-edge fill with the sequential reference's result:
    mask existing edges with one whole-row compare (rows are front-packed),
    keep the first occurrence per (src, dst), and a STABLE argsort by src
    keeps ravel order within each src, so the rank within src is the
    reference's slot offset -- overflow candidates included."""
    nbrs = nbrs.copy()
    n = nbrs.shape[0]
    slots0 = np.sum(nbrs >= 0, axis=1)
    src = nbrs.ravel()
    dst = np.repeat(np.arange(n), r)
    ok = (src >= 0) & (src != dst)
    idx = np.nonzero(ok)[0]
    exists = np.any(nbrs[src[idx]] == dst[idx, None], axis=1)
    idx = idx[~exists]
    key = src[idx].astype(np.int64) * n + dst[idx]
    _, first = np.unique(key, return_index=True)
    idx = idx[np.sort(first)]                     # ravel order restored
    order = np.argsort(src[idx], kind="stable")
    idx = idx[order]
    s_sorted = src[idx]
    counts = np.bincount(s_sorted, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(idx.size) - starts[s_sorted]
    slot = slots0[s_sorted] + rank
    keep = slot < r
    nbrs[s_sorted[keep], slot[keep]] = dst[idx][keep]
    return nbrs


def _dedupe_rows(nbrs: np.ndarray) -> np.ndarray:
    """Mask repeated ids within each row to -1 (keep the first occurrence):
    a duplicate edge would let the gathered ``expand=1`` hop put one vertex
    in two beam slots, so the builds emit duplicate-free rows and the
    gathered and fused traversals agree on every built graph."""
    order = np.argsort(nbrs, axis=1, kind="stable")
    snb = np.take_along_axis(nbrs, order, axis=1)
    dup_sorted = np.concatenate(
        [np.zeros((nbrs.shape[0], 1), bool),
         (snb[:, 1:] == snb[:, :-1]) & (snb[:, 1:] >= 0)], axis=1)
    dup = np.zeros(nbrs.shape, bool)
    np.put_along_axis(dup, order, dup_sorted, axis=1)
    return np.where(dup, -1, nbrs)


def _entry_points(x: torch.Tensor, n_entries: int, seed: int) -> np.ndarray:
    """Medoid + the database vectors nearest to spherical k-means centroids
    (the clustering GleanVec uses), deduplicated, so every mixture
    component is reachable in one hop. ``x`` lies on the device that runs
    the k-means; its ``torch.Generator`` is seeded from ``seed`` (the
    reference draws from a ``jax.random`` key, so the entries differ)."""
    n = x.shape[0]
    d2 = torch.sum((x - x.mean(dim=0, keepdim=True)) ** 2, dim=1)
    entries = [int(torch.argmin(d2))]
    if n_entries > 1:
        gen = torch.Generator(device=x.device).manual_seed(seed)
        km = spherical_kmeans.fit(x, min(n_entries - 1, max(2, n // 64)),
                                  n_iters=10, generator=gen, device=x.device)
        sims = spherical_kmeans.normalize_rows(x) @ km.centers.T
        entries.extend(int(i) for i in torch.argmax(sims, dim=0).tolist())
    return np.unique(np.asarray(entries, np.int32))


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def build(x, r: int = 32, alpha: float = 1.2, n_iters: int = 6,
          n_random: int = 4, n_entries: int = 16, seed: int = 0,
          method: str = "numpy", device=None,
          timings: Optional[dict] = None) -> GraphIndex:
    """Build a degree-(R + n_random) navigable graph over ``x`` (numpy or
    a tensor) on ``device`` (default: the GPU).

    ``method``: "numpy" (NN-descent + RobustPrune on the host, the
    reference's draws exactly), "device" (:func:`build_device`), or "auto"
    (device at ``n >= _DEVICE_BUILD_MIN_N``, numpy below). Both add
    ``n_random`` long-range out-edges per node and ``n_entries`` entry
    points (:func:`_entry_points`): clustered data yields disconnected
    k-NN graphs, on which greedy search stalls. ``timings`` goes to
    :func:`build_device`."""
    dev = resolve_device(device)
    n = x.shape[0]
    if method == "device" or (method == "auto" and n >= _DEVICE_BUILD_MIN_N):
        return build_device(x, r=r, n_random=n_random, n_entries=n_entries,
                            seed=seed, device=dev, timings=timings)
    if method not in ("numpy", "auto"):
        raise ValueError(f"unknown graph build method: {method!r}")
    x_np = np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float32)
    rng = np.random.default_rng(seed)
    cand = _nn_descent(x_np, r, n_iters, rng)          # (n, 2R) sorted
    nbrs = _robust_prune(x_np, cand, r, alpha)         # (n, R), -1 padded
    nbrs = _reverse_edge_fill(nbrs, r)
    if n_random > 0:
        rand_edges = rng.integers(0, n, size=(n, n_random), dtype=np.int64)
        nbrs = _dedupe_rows(np.concatenate([nbrs, rand_edges], axis=1))
    entries = _entry_points(_as_tensor(x, dev), n_entries, seed)
    return GraphIndex(
        neighbors=torch.as_tensor(nbrs.astype(np.int32), device=dev),
        entries=torch.as_tensor(entries, device=dev))


# ---------------------------------------------------------------------------
# Build (on the device, CAGRA-style): a fused-kernel k-NN self-join and
# rank-based detour pruning -- no dense (n, n) matrix.
# ---------------------------------------------------------------------------


def _device_knn(x: torch.Tensor, k: int, batch: int = 1024) -> torch.Tensor:
    """Exact k-NN ids (self excluded, distance ascending), (n, k) int64 on
    ``x``'s device, through the fused ``scorer_topk`` kernel: rows ``[x,
    -||x||^2 / 2]`` and queries ``[q, 1]`` make inner-product top-k return
    exact L2 order, so the self-join is a blocked ``ip_topk`` (k + 1 per
    query, d + 1 wide). Rows and queries carry zero columns up to a
    multiple of 4 wide (d = 512: 513 -> 516), so the kernel stages
    16-byte-aligned rows; a zero column adds fma(0, 0, acc) = acc to a
    score, so the ids and values are those of the d + 1 columns."""
    from repro_torch import kernels
    n, d = x.shape
    width = -(-(d + 1) // 4) * 4
    xa = torch.zeros((n, width), dtype=torch.float32, device=x.device)
    xa[:, :d] = x
    xa[:, d] = -0.5 * torch.sum(x * x, dim=1)
    scorer = LinearScorer(x_low=xa)
    out = torch.empty((n, k), dtype=torch.int64, device=x.device)
    qa = torch.zeros((min(batch, n), width), dtype=torch.float32,
                     device=x.device)
    qa[:, d] = 1.0
    for s in range(0, n, batch):
        e = min(s + batch, n)
        q = qa[:e - s]
        q[:, :d] = x[s:e]
        _, ids = kernels.scorer_topk(scorer, q, k + 1)
        # drop self (rank 0 barring exact duplicates); a stable compaction
        # keeps the remaining k in distance order
        keep = ids != torch.arange(s, e, device=x.device)[:, None]
        sel = torch.sort((~keep).to(torch.int8), dim=1,
                         stable=True).indices[:, :k]
        out[s:e] = torch.gather(ids, 1, sel).to(torch.int64)
    return out


def _detour_mask(knn: torch.Tensor, nbr_c: torch.Tensor) -> torch.Tensor:
    """CAGRA rank-based pruning predicate for one chunk of nodes: ``nbr_c
    (b, k0)`` distance-ascending neighbor ids, ``knn (n, k0)`` the full
    table. Edge p -> u_j is a detour iff some closer neighbor u_i (i < j)
    holds u_j at rank < j in ITS list (the reference's ``min`` rank
    written as "some slot < j hits")."""
    k0 = nbr_c.shape[1]
    dev = nbr_c.device
    wn = knn[nbr_c]                                        # (b, k0, k0)
    hit = wn[:, :, None, :] == nbr_c[:, None, :, None]     # (b, i, j, slot)
    j = torch.arange(k0, device=dev)
    lower = j[:, None] < j[None, :]                    # [i, j]: i < j
    early = j[None, :] < j[:, None]                    # [j, slot]: slot < j
    hit &= lower[None, :, :, None]
    hit &= early[None, None, :, :]
    return hit.any(dim=3).any(dim=1)


def build_device(x, r: int = 32, k_base: Optional[int] = None,
                 n_random: int = 4, n_entries: int = 16, seed: int = 0,
                 batch: int = 1024, device=None,
                 timings: Optional[dict] = None) -> GraphIndex:
    """CAGRA-style build on the device: a ``k_base``-NN graph from the
    fused self-join (:func:`_device_knn`), detour edges pruned by rank
    (:func:`_detour_mask`, chunked), then the numpy build's reverse-edge
    fill, random long-range edges and entry points. ``timings`` (a dict)
    receives the seconds of each step (host clock after a synchronise):
    ``self_join``, ``detour_prune``, ``reverse_fill``, ``entry_points``."""
    import time
    dev = resolve_device(device)
    xt = _as_tensor(x, dev)
    n = xt.shape[0]
    k0 = k_base if k_base is not None else min(2 * r, n - 1)
    times = {} if timings is None else timings

    def lap(name, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times[name] = time.perf_counter() - t0
        return time.perf_counter()

    t = time.perf_counter()
    knn = _device_knn(xt, k0, batch=batch)
    t = lap("self_join", t)
    nbrs = torch.full((n, r), -1, dtype=torch.int64, device=dev)
    chunk = max(16, _DETOUR_CHUNK_ELEMS.get(dev.type, 2 ** 24)
                // max(1, k0 ** 3))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        kept = ~_detour_mask(knn, knn[s:e])                # (b, k0)
        pos = torch.cumsum(kept.to(torch.int64), dim=1) - 1
        sel = kept & (pos < r)
        rows, _ = torch.nonzero(sel, as_tuple=True)
        nbrs[rows + s, pos[sel]] = knn[s:e][sel]
    nbrs = nbrs.cpu().numpy()
    t = lap("detour_prune", t)
    nbrs = _reverse_edge_fill(nbrs, r)
    rng = np.random.default_rng(seed)
    if n_random > 0:
        rand_edges = rng.integers(0, n, size=(n, n_random), dtype=np.int64)
        nbrs = _dedupe_rows(np.concatenate([nbrs, rand_edges], axis=1))
    t = lap("reverse_fill", t)
    entries = _entry_points(xt, n_entries, seed)
    lap("entry_points", t)
    return GraphIndex(
        neighbors=torch.as_tensor(nbrs.astype(np.int32), device=dev),
        entries=torch.as_tensor(entries, device=dev))


# ---------------------------------------------------------------------------
# Search: batched best-first beam search.
# ---------------------------------------------------------------------------


def _best_slots(scores: torch.Tensor, e: int) -> torch.Tensor:
    """Indices of the ``e`` largest of each row, ties to the lower index
    (``jax.lax.top_k``'s order): a stable descending sort."""
    return torch.sort(scores, dim=1, descending=True,
                      stable=True).indices[:, :e]


def _beam_member_mask(ids: torch.Tensor, nbrs: torch.Tensor) -> torch.Tensor:
    """(batch, P) membership of ``nbrs`` in the per-row ``ids`` beam, via a
    per-row sort + searchsorted."""
    beam = ids.shape[1]
    sorted_ids = torch.sort(ids, dim=1).values
    pos = torch.searchsorted(sorted_ids, nbrs.to(sorted_ids.dtype))
    pos = pos.clamp(0, beam - 1)
    return torch.gather(sorted_ids, 1, pos) == nbrs


def _mask_duplicate_nbrs(nbrs: torch.Tensor) -> torch.Tensor:
    """Set repeated ids within each row of ``nbrs`` to -1 (keep the first
    occurrence): multi-expansion hops gather overlapping neighborhoods."""
    order = torch.argsort(nbrs, dim=1, stable=True)
    snb = torch.gather(nbrs, 1, order)
    dup_sorted = torch.cat(
        [torch.zeros((nbrs.shape[0], 1), dtype=torch.bool,
                     device=nbrs.device), snb[:, 1:] == snb[:, :-1]], dim=1)
    dup = torch.zeros_like(dup_sorted).scatter(1, order, dup_sorted)
    return torch.where(dup, torch.full_like(nbrs, -1), nbrs)


def gathered_beam_step(score_ids, nbr_tbl: torch.Tensor, scores, ids,
                       visited, best_ids, sel_ok, beam: int):
    """One GATHERED hop merge: gather the popped vertices' neighbors from
    ``nbr_tbl`` (original-id space), score them via ``score_ids``, dedupe
    against the beam and merge into the top ``beam`` (stable: beam slots
    before candidates among equal scores, as ``jax.lax.top_k``). The
    composed-torch counterpart of the fused kernel."""
    batch = ids.shape[0]
    e = best_ids.shape[1]
    r = nbr_tbl.shape[1]
    safe = torch.where(best_ids >= 0, best_ids, torch.zeros_like(best_ids))
    nbrs = nbr_tbl[safe.long()]                            # (b, e, R)
    nbrs = torch.where((nbrs >= 0) & sel_ok[:, :, None], nbrs,
                       torch.full_like(nbrs, -1)).reshape(batch, e * r)
    if e > 1:       # overlapping neighborhoods: drop within-hop dups
        nbrs = _mask_duplicate_nbrs(nbrs)
    nscores = score_ids(nbrs)
    nscores = torch.where(nbrs >= 0, nscores,
                          torch.full_like(nscores, NEG_INF))
    present = _beam_member_mask(ids, nbrs)
    nscores = torch.where(present, torch.full_like(nscores, NEG_INF),
                          nscores)
    all_scores = torch.cat([scores, nscores], dim=1)
    all_ids = torch.cat([ids, nbrs.to(ids.dtype)], dim=1)
    all_vis = torch.cat([visited, torch.zeros((batch, e * r),
                                              dtype=torch.bool,
                                              device=ids.device)], dim=1)
    sel = _best_slots(all_scores, beam)
    return (torch.gather(all_scores, 1, sel), torch.gather(all_ids, 1, sel),
            torch.gather(all_vis, 1, sel))


def _entry_beam(score_ids, graph: GraphIndex, batch: int, beam: int):
    """The scored entry beam (scores, ids) (batch, beam) in slot order: the
    entry points first (-1-padded entries at NEG_INF), then -1 slots."""
    dev = graph.neighbors.device
    n_entry = graph.entries.shape[0]
    if n_entry > beam:
        raise ValueError(f"the beam ({beam}) must hold all {n_entry} entry "
                         "points")
    entry = graph.entries[None, :].expand(batch, n_entry).to(torch.int32)
    e_scores = score_ids(entry).to(torch.float32)
    # -1-padded entries never enter the beam
    e_scores = torch.where(entry >= 0, e_scores,
                           torch.full_like(e_scores, NEG_INF))
    ids = torch.cat([entry, torch.full((batch, beam - n_entry), -1,
                                       dtype=torch.int32, device=dev)], 1)
    scores = torch.cat([e_scores, torch.full((batch, beam - n_entry),
                                             NEG_INF, device=dev)], 1)
    return scores, ids


def _beam_loop(score_ids, graph: GraphIndex, batch: int, beam: int,
               max_hops: int, expand: int = 1,
               trace_tags: Optional[torch.Tensor] = None, fused_step=None):
    """Shared traversal. ``score_ids(ids) -> (batch, p) scores`` for ids
    >= 0. Returns (scores, ids, n_hops, tag_trace) with tag_trace (batch,
    max_hops) = tag of the BEST vertex expanded at each hop (-1 = no hop),
    for Figure 7. ``fused_step(scores, ids, visited, best_ids, sel_ok) ->
    (scores, ids, visited)`` replaces the gathered merge with the
    gather-free kernel (:func:`fused_hop_step`; same top-``beam``
    multiset; order is irrelevant to every consumer).

    The reference's ``while_loop`` as a Python loop: its condition reads
    ``any(expandable)`` from the device once per hop."""
    nbr_tbl = graph.neighbors
    e = max(1, expand)
    if e > beam:
        raise ValueError(f"expand {e} must not exceed the beam width {beam}")
    dev = nbr_tbl.device
    scores, ids = _entry_beam(score_ids, graph, batch, beam)
    visited = torch.zeros((batch, beam), dtype=torch.bool, device=dev)
    tag_hist = torch.full((batch, max_hops), -1, dtype=torch.int32,
                          device=dev)
    hop = 0
    while hop < max_hops:
        expandable = (~visited) & (ids >= 0)
        has_work = torch.any(expandable, dim=1)
        if not bool(torch.any(has_work)):          # host sync per hop
            break
        masked = torch.where(expandable, scores,
                             torch.full_like(scores, NEG_INF))
        best = _best_slots(masked, e)                      # (batch, e)
        # slots that hold expandable work (fewer than e frontier vertices
        # -> the overflow selections are no-ops)
        sel_ok = torch.gather(expandable, 1, best)
        if e == 1:      # exact classic semantics: gate on the row
            sel_ok = has_work[:, None]
        best_ids = torch.gather(ids, 1, best)
        visited = visited.scatter(1, best,
                                  torch.gather(visited, 1, best) | sel_ok)
        if fused_step is not None:
            scores, ids, visited = fused_step(scores, ids, visited, best_ids,
                                              sel_ok)
        else:
            scores, ids, visited = gathered_beam_step(
                score_ids, nbr_tbl, scores, ids, visited, best_ids, sel_ok,
                beam)
        if trace_tags is not None:
            first = best_ids[:, 0]
            ok = (first >= 0) & has_work
            tag = trace_tags[torch.where(first >= 0, first,
                                         torch.zeros_like(first)).long()]
            tag_hist[:, hop] = torch.where(ok, tag.to(torch.int32),
                                           torch.full_like(first, -1))
        hop += 1
    return scores, ids, hop, tag_hist


def _score_ids_of(qstate, scorer):
    """``score_ids(ids)`` of prepared queries, ids < 0 read as row 0 (the
    traversal masks them)."""
    def score_ids(ids):
        safe = torch.where(ids >= 0, ids, torch.zeros_like(ids))
        return scorer.score_ids(qstate, safe)
    return score_ids


def fused_hop_step(qstate, scorer, graph: GraphIndex, beam: int,
                   expand: int = 1):
    """The per-hop gather-free step of :func:`_beam_loop` for a fused graph:
    the popped vertices' pre-translated sorted rows (``nbr_rows``) go
    straight to ``scorer.scan_neighbors`` (one ``graph_scan_beam_step``
    launch), and the visited flags follow their entries' IDS through the
    merge (sort + searchsorted against the pre-hop beam), which is the
    gathered path's permutation of flags, since beam ids are distinct. The
    traced fused traversal hops through it; ``graph_beam_search`` runs the
    same hops in one launch."""
    m = (qstate.q_scaled if isinstance(qstate, tuple) else qstate).shape[0]
    nbr_rows_tbl = graph.nbr_rows
    e = max(1, expand)

    def step(scores, ids, visited, best_ids, sel_ok):
        safe = torch.where(best_ids >= 0, best_ids,
                           torch.zeros_like(best_ids))
        nrows = nbr_rows_tbl[safe.long()]
        nrows = torch.where((nrows >= 0) & sel_ok[:, :, None], nrows,
                            torch.full_like(nrows, -1))
        nrows = nrows.reshape(m, e * nbr_rows_tbl.shape[1]).contiguous()
        new_scores, new_ids = scorer.scan_neighbors(
            qstate, nrows, scores.contiguous(), ids.contiguous(),
            tn=graph.scan_tn)
        order = torch.argsort(ids, dim=1, stable=True)
        sorted_ids = torch.gather(ids, 1, order)
        sorted_vis = torch.gather(visited, 1, order)
        pos = torch.searchsorted(sorted_ids, new_ids).clamp(0, beam - 1)
        match = torch.gather(sorted_ids, 1, pos) == new_ids
        new_vis = match & torch.gather(sorted_vis, 1, pos)
        return new_scores, new_ids, new_vis

    return step


def _beam_qstate(qstate, scorer, graph: GraphIndex, k: int, beam: int,
                 max_hops: int, expand: int = 1,
                 trace_tags: Optional[torch.Tensor] = None):
    """Traversal over any scorer with prepared queries ``qstate``.

    Every scorer with a lowering (the four gathered classes over the id
    table; a tag-sorted one over a fused graph's ``nbr_rows``) runs the
    whole search in one ``graph_beam_search`` launch
    (``kernels.scorer_beam_search``) from the scored entry beam; its hop
    count comes back as a device scalar (the most hops of any query), so
    nothing waits on the device between the query upload and the result.
    Asked for the tag trace (Figure 7), the search hops through
    :func:`_beam_loop` instead (a fused graph with :func:`fused_hop_step`,
    else :func:`gathered_beam_step`), as does a scorer with no lowering.
    The hop count is then a Python int."""
    from repro_torch import kernels
    m = (qstate.q_scaled if isinstance(qstate, tuple) else qstate).shape[0]
    score_ids = _score_ids_of(qstate, scorer)
    fused = graph.fused and graph.nbr_rows is not None \
        and hasattr(scorer, "scan_neighbors")
    table = graph.nbr_rows if fused else (
        graph.neighbors if kernels.gathered_beam_lowering(scorer) else None)
    if table is not None and trace_tags is None:
        scores, ids = _entry_beam(score_ids, graph, m, beam)
        scores, ids, q_hops = kernels.scorer_beam_search(
            scorer, qstate, table, scores, ids, max_hops, expand)
        hops = q_hops.amax() if m else q_hops.new_zeros(())
        tag_hist = None
    else:
        fused_step = (fused_hop_step(qstate, scorer, graph, beam, expand)
                      if fused else None)
        scores, ids, hops, tag_hist = _beam_loop(
            score_ids, graph, m, beam, max_hops, expand=expand,
            trace_tags=trace_tags, fused_step=fused_step)
    if k > beam:        # kappa > beam (e.g. kappa > n): pad with -1 slots
        fill = k - beam
        scores = torch.cat([scores, torch.full((m, fill), NEG_INF,
                                               dtype=scores.dtype,
                                               device=scores.device)], 1)
        ids = torch.cat([ids, torch.full((m, fill), -1, dtype=ids.dtype,
                                         device=ids.device)], 1)
    sel = _best_slots(scores, k)
    return (torch.gather(scores, 1, sel), torch.gather(ids, 1, sel), hops,
            tag_hist)


def beam_search_scorer(queries, scorer, graph: GraphIndex, k: int,
                       beam: int = 64, max_hops: int = 256, expand: int = 1,
                       trace: bool = False):
    """Unified-protocol beam search: ``queries (m, D)`` full-dimension.
    With ``trace=True`` also returns (n_hops, (m, max_hops) tag trace); it
    needs a scorer with ``tags`` (Figure 7)."""
    qstate = scorer.prepare_queries(queries)
    trace_tags = getattr(scorer, "tags", None) if trace else None
    if trace and trace_tags is None:
        raise ValueError("trace=True needs a tagged scorer (GleanVec*)")
    top, ids, hops, tag_hist = _beam_qstate(qstate, scorer, graph, k, beam,
                                            max_hops, expand=expand,
                                            trace_tags=trace_tags)
    if trace:
        return top, ids, hops, tag_hist
    return top, ids


def beam_search(q_low, x_low, graph: GraphIndex, k: int, beam: int = 64,
                max_hops: int = 256):
    """Linear scoring: q_low (m, d), x_low (n, d) -> (vals, ids) (m, k)."""
    top, ids, _, _ = _beam_qstate(q_low, LinearScorer(x_low=x_low), graph,
                                  k, beam, max_hops)
    return top, ids


def beam_search_gleanvec(q_views, tags, x_low, graph: GraphIndex, k: int,
                         beam: int = 64, max_hops: int = 256):
    """Eager GleanVec scoring (Alg. 4): q_views (m, C, d), tags (n,)."""
    scorer = GleanVecScorer(x_low=x_low, tags=tags)
    top, ids, _, _ = _beam_qstate(q_views, scorer, graph, k, beam, max_hops)
    return top, ids


def beam_search_traced(q_views, tags, x_low, graph: GraphIndex, k: int,
                       beam: int = 64, max_hops: int = 256):
    """GleanVec search that also returns the hop count and the per-hop
    expanded-vertex tag sequence (m, max_hops) -- Figure 7's measurement."""
    scorer = GleanVecScorer(x_low=x_low, tags=tags)
    return _beam_qstate(q_views, scorer, graph, k, beam, max_hops,
                        trace_tags=tags)
