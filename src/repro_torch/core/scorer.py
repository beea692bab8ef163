"""Scorers: one database representation plus its scoring contract (port of
the static-serving part of ``repro/core/scorer.py``).

    qstate = scorer.prepare_queries(q)             # Alg. 1 line 1
    vals, ids = kernels.scorer_topk_prepared(scorer, qstate, k)

A scorer holds its encoded rows and prepares queries; the fused scan of
each scorer class lives in its CUDA kernel, lowered in one place,
:mod:`repro_torch.kernels` (``scorer_topk``), whose plain versions are the
scan on CPU tensors. The sorted scorers store a private tag-sorted row
order (``perm``: sorted row -> original id, -1 on padding) that the kernel
takes as its ``row_ids``, so ids come out in the original space.

For the IVF index every scorer also scores gathered ORIGINAL ids
(``score_ids``, plain PyTorch gathers: the gathered fine step) and encodes
the coarse centers into a companion scorer that consumes its prepared
queries (``encode_centers``; the companions' ``score_block`` is the
reduced-space probe). The sorted scorers carry ``list_block_ranges``
((C, max_blocks) layout blocks per cluster, -1-padded) and
``scan_lists(qstate, probe, k)``: the gather-free fine step of an IVF
whose clusters are their tags, lowered through
``kernels.scorer_scan_lists`` to the ``ivf_scan_topk`` kernel, and
``scan_neighbors(qstate, nbr_rows, beam_vals, beam_ids, tn)``: the
gather-free hop of a graph bound to their layout, lowered through
``kernels.scorer_scan_neighbors`` to ``graph_scan_beam_step`` (the whole
traversal of such a graph lowers through ``kernels.scorer_beam_search`` to
``graph_beam_search``).

    ==========================  =========================  ================
    scorer                      storage                    scoring
    ==========================  =========================  ================
    LinearScorer                f32 x_low = Bx (d dims)    <Aq, Bx>
    GleanVecScorer              f32 B_c x + tag (Alg. 4)   <A_c q, B_c x>
    QuantizedScorer             u8 codes of Bx + (d) scale <Aq*delta, u>+...
    GleanVecQuantizedScorer     u8 codes of B_c x + tag    per-cluster SQ
    SortedGleanVecScorer        f32 B_c x, tag-sorted      one view/block
    SortedGleanVecQuantized-    u8 codes, tag-sorted       per-cluster SQ,
    Scorer                                                 one view/block
    ==========================  =========================  ================

Streaming (Section 3.2): a store built by
:func:`repro_torch.core.streaming.build_streaming_artifacts` has a fixed
capacity. The four row-aligned scorers carry a ``live`` mask ((n,) bool;
``None`` = every row live) under which dead slots score NEG_INF and
translate to id -1; the sorted scorers mark free slots with ``perm == -1``
inside each cluster's blocks. ``insert_rows`` / ``remove_rows`` /
``refresh`` return a new scorer with the same classes, shapes and dtypes,
so the serving engine swaps it in. They never write into the scorer they
are called on (``index_put`` makes new tensors): the engine keeps serving
the installed state until the swap. ``refresh`` re-encodes cluster by
cluster (``gleanvec.project_per_cluster``) where the reference gathers
per-row (d, D) and (d, d) matrices.

Sharding: ``shard_rows(s, n_shards)`` is the torch counterpart of the
reference's ``shard_specs``: a scorer of the same class whose row leaves
are rows ``[s n / S, (s + 1) n / S)`` as views, the leaves ``shard_specs``
replicates kept whole (``a``, ``lo`` / ``delta``, ``inv_perm``,
``list_block_ranges``). ``globalize_ids(ids, shard_idx)`` lifts a row
shard's ids to global ids: the row-aligned scorers offset them by
``shard_idx * n_rows``; the sorted ones return them, since their ``perm``
holds global ids (a sorted layout is built over the whole database, then
row-sharded, and S must divide its block count).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core import gleanvec as gv
from repro_torch.core import quantization as quant
from repro_torch.device import resolve_device
from repro_torch.index.topk import NEG_INF

__all__ = [
    "LinearScorer", "GleanVecScorer", "QuantizedScorer",
    "GleanVecQuantizedScorer", "SortedGleanVecScorer",
    "SortedGleanVecQuantizedScorer", "QuantQueryState", "Scorer", "MODES",
    "build_scorer", "linear_scorer", "exact_scorer", "gleanvec_scorer",
    "quantized_scorer", "gleanvec_quantized_scorer",
    "sorted_gleanvec_scorer", "sorted_gleanvec_quantized_scorer",
]


class QuantQueryState(NamedTuple):
    """Prepared query for int8 scorers: the affine terms folded query-side.

    ``q_scaled``: (m, d) [linear] or (m, C, d) [per-cluster] = Aq * delta;
    ``q_lo``:     (m,)               or (m, C)              = <Aq, lo>.
    """

    q_scaled: torch.Tensor
    q_lo: torch.Tensor


def _views(a: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Eager per-cluster views A_c q: (m, C, d) from a (C, d, D)."""
    c, d, dim = a.shape
    q = queries.to(torch.float32)
    return (q @ a.reshape(c * d, dim).T).reshape(q.shape[0], c, d)


def _list_block_ranges(block_tags: torch.Tensor, c: int) -> torch.Tensor:
    """(C, max_blocks) int32 table of layout-block indices per cluster,
    -1-padded: ``ranges[probe]`` is the probe schedule of the
    ``ivf_scan_topk`` kernel. One stable argsort + bincount pass, as the
    reference (blocks with a negative tag are left out)."""
    dev = block_tags.device
    blocks = torch.nonzero(block_tags >= 0).squeeze(1)
    t = block_tags[blocks].to(torch.int64)
    counts = torch.bincount(t, minlength=c)
    maxb = max(1, int(counts.max()) if t.numel() else 1)
    starts = torch.cumsum(counts, 0) - counts
    order = torch.argsort(t, stable=True)
    rank = torch.arange(t.numel(), device=dev) - starts[t[order]]
    out = torch.full((c, maxb), -1, dtype=torch.int32, device=dev)
    out[t[order], rank] = blocks[order].to(torch.int32)
    return out


def _center_views_scorer(centers: torch.Tensor, model) -> "GleanVecScorer":
    """Probe companion of the eager-view family (GleanVec and its sorted
    layout): the centers tagged and projected per cluster."""
    if model is None:
        raise ValueError("encode_centers on a GleanVec-family scorer "
                         "needs the GleanVec model")
    tags, low = gv.encode_database(model, centers.to(torch.float32))
    return GleanVecScorer(x_low=low, tags=tags)


def _center_pseudo_scorer(centers: torch.Tensor, model, lo, delta,
                          a) -> "GleanVecQuantizedScorer":
    """Probe companion of the folded per-cluster int8 family: projected
    centers stored as f32 pseudo-codes ``(B_t c - lo_t) / delta_t`` under
    the database's scales, so ``q_scaled . codes + q_lo == <A_t q, B_t c>``
    without rounding."""
    if model is None:
        raise ValueError("encode_centers on a GleanVec-family scorer "
                         "needs the GleanVec model")
    tags, low = gv.encode_database(model, centers.to(torch.float32))
    t = tags.to(torch.int64)
    return GleanVecQuantizedScorer(codes=(low - lo[t]) / delta[t], tags=tags,
                                   lo=lo, delta=delta, a=a)


def _gather_views(q: torch.Tensor, tag: torch.Tensor) -> torch.Tensor:
    """(m, p, d) views ``q[m, tag[m, p]]`` of (m, C, d) prepared queries."""
    m = q.shape[0]
    return q[torch.arange(m, device=q.device)[:, None], tag]


def _globalize_row_aligned(ids: torch.Tensor, shard_idx,
                           n_rows: int) -> torch.Tensor:
    """Row-aligned ``globalize_ids``: offset local ids by the shard's row
    count; -1 stays -1."""
    return torch.where(ids >= 0, ids + shard_idx * n_rows,
                       torch.full_like(ids, -1))


def _row_range(n: int, s: int, n_shards: int):
    if n_shards < 1 or not 0 <= s < n_shards:
        raise ValueError(f"shard {s} of {n_shards} does not exist")
    if n % n_shards:
        raise ValueError(f"{n} rows do not split into {n_shards} equal "
                         "shards")
    per = n // n_shards
    return s * per, (s + 1) * per


def _shard_leaves(scorer, s: int, n_shards: int, row_fields):
    """``scorer`` with each of ``row_fields`` (first dimension ``n_rows``)
    cut to shard ``s``'s rows as a view; every other leaf is kept whole."""
    lo, hi = _row_range(scorer.n_rows, s, n_shards)
    return scorer._replace(**{
        f: getattr(scorer, f)[lo:hi] for f in row_fields
        if getattr(scorer, f) is not None})


def _shard_sorted(scorer, s: int, n_shards: int, row_field: str):
    """Row shard of a sorted layout: whole single-tag blocks only, so S
    must divide the block count; ``perm`` keeps its global ids."""
    nb = scorer.block_tags.shape[0]
    if nb % n_shards:
        raise ValueError(f"a sorted layout of {nb} blocks does not split "
                         f"into {n_shards} shards of whole blocks")
    b0, b1 = _row_range(nb, s, n_shards)
    lb = scorer.layout_block
    return scorer._replace(**{
        row_field: getattr(scorer, row_field)[b0 * lb:b1 * lb],
        "block_tags": scorer.block_tags[b0:b1],
        "perm": scorer.perm[b0 * lb:b1 * lb]})


def _sorted_rows(scorer, ids: torch.Tensor):
    """Sorted rows of ORIGINAL ``ids`` (m, p), their tags and a mask of the
    ids the layout holds (absent ids score NEG_INF)."""
    rows = scorer.inv_perm[ids.long()].long()
    ok = rows >= 0
    rows = torch.where(ok, rows, torch.zeros_like(rows))
    tag = scorer.block_tags[rows // scorer.layout_block].long()
    return rows, tag, ok


# ---------------------------------------------------------------------------
# Streaming-store helpers: the ``live`` mask and the row-level updates.
# ---------------------------------------------------------------------------


def _put(t: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """``t`` with ``t[idx] = values``, as a new tensor (``t`` unchanged)."""
    if not torch.is_tensor(values):
        values = torch.tensor(values, dtype=t.dtype, device=t.device)
    return t.index_put((idx.long(),), values.to(t.dtype))


def _mask_live_block(live, start: int, block: int, scores: torch.Tensor):
    if live is None:
        return scores
    lv = live[start:start + block]
    return torch.where(lv[None, :], scores, torch.full_like(scores, NEG_INF))


def _mask_live_ids(live, ids: torch.Tensor, scores: torch.Tensor):
    if live is None:
        return scores
    return torch.where(live[ids.long()], scores,
                       torch.full_like(scores, NEG_INF))


def _translate_live(live, n_rows: int, ids: torch.Tensor) -> torch.Tensor:
    """Row-aligned id translation under a live mask: dead (or out of
    range) rows map to -1, so they never reach the rerank."""
    if live is None:
        return ids
    safe = ids.clamp(0, n_rows - 1).long()
    ok = (ids >= 0) & (ids < n_rows) & live[safe]
    return torch.where(ok, ids, torch.full_like(ids, -1))


def _set_live(live, ids: torch.Tensor, value: bool, n_rows: int,
              device) -> Optional[torch.Tensor]:
    """Live-mask update. ``None`` (all live) stays ``None`` on insert and
    is materialised on the first remove -- which changes the scorer's
    structure, so the engine refuses that swap; streaming stores carry a
    mask from the start."""
    if live is None:
        if value:
            return None
        live = torch.ones((n_rows,), dtype=torch.bool, device=device)
    return _put(live, ids, value)


def _code_rows(low: torch.Tensor, lo: torch.Tensor,
               delta: torch.Tensor) -> torch.Tensor:
    """8-bit codes of new rows under EXISTING scales (clipped); the next
    ``refresh`` refits the scales. Streaming assumes the serving modes'
    8-bit coding, as the reference."""
    return torch.clamp(torch.round((low - lo) / delta), 0,
                       255).to(torch.uint8)


def _sorted_claim_slots(perm, inv_perm, block_tags, layout_block: int, ids,
                        tags):
    """Slots for new rows in a sorted layout: the r-th new row of cluster c
    (in input order) takes the r-th free slot (``perm == -1``, ascending)
    of c's blocks, after the old slots of re-inserted live ids are released
    (re-insert == overwrite). The same slots as the reference's per-row
    loop, in one stable sort of each side. Returns ``(slots, freed)``;
    raises when a cluster is out of free slots."""
    dev = perm.device
    ids = ids.long()
    old = inv_perm[ids].long()
    freed = old[old >= 0]
    free = perm < 0
    free[freed] = True
    free_rows = torch.nonzero(free).squeeze(1)                 # ascending
    free_tags = block_tags[free_rows // layout_block].long()
    keep = free_tags >= 0
    free_rows, free_tags = free_rows[keep], free_tags[keep]
    t = tags.long()
    c = int(max(int(block_tags.max()), int(t.max()) if t.numel() else 0)) + 1
    have = torch.bincount(free_tags, minlength=c)
    need = torch.bincount(t, minlength=c)
    order = torch.argsort(t, stable=True)
    first = torch.cumsum(need, 0) - need
    rank = torch.empty_like(t)
    rank[order] = torch.arange(t.numel(), device=dev) - first[t[order]]
    short = torch.nonzero(rank >= have[t]).squeeze(1)
    if short.numel():
        raise ValueError(
            f"sorted layout: cluster {int(t[short[0]])} has no free slots; "
            "rebuild the layout with more slack_blocks")
    f_order = torch.argsort(free_tags, stable=True)
    f_first = torch.cumsum(have, 0) - have
    slots = free_rows[f_order[f_first[t] + rank]]
    return slots, freed


class LinearScorer(NamedTuple):
    """Linear DR scoring <Aq, Bx>; ``a=None`` is exact MIPS over ``x_low``
    (the 'full' mode, whose ``x_low`` is the full-precision database)."""

    x_low: torch.Tensor                 # (n, d)
    a: Optional[torch.Tensor] = None    # (d, D) query transform
    live: Optional[torch.Tensor] = None  # (n,) bool slot mask (None = all)

    @property
    def n_rows(self) -> int:
        return self.x_low.shape[0]

    def prepare_queries(self, queries: torch.Tensor) -> torch.Tensor:
        q = queries.to(torch.float32)
        return q if self.a is None else q @ self.a.T

    def score_block(self, qstate: torch.Tensor, start: int,
                    block: int) -> torch.Tensor:
        return _mask_live_block(self.live, start, block,
                                qstate @ self.x_low[start:start + block].T)

    def score_ids(self, qstate: torch.Tensor, ids: torch.Tensor):
        vecs = self.x_low[ids.long()]                  # (m, p, d)
        return _mask_live_ids(self.live, ids,
                              torch.einsum("mpd,md->mp", vecs, qstate))

    def translate_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return _translate_live(self.live, self.n_rows, ids)

    def shard_rows(self, s: int, n_shards: int) -> "LinearScorer":
        return _shard_leaves(self, s, n_shards, ("x_low", "live"))

    def globalize_ids(self, ids: torch.Tensor, shard_idx) -> torch.Tensor:
        return _globalize_row_aligned(ids, shard_idx, self.n_rows)

    # ---- streaming row-level ops (Section 3.2) ----

    def insert_rows(self, ids: torch.Tensor, rows: torch.Tensor,
                    model=None) -> "LinearScorer":
        """Encode full-D ``rows`` into slots ``ids`` and mark them live."""
        rows = rows.to(torch.float32)
        enc = rows if self.a is None else rows @ model.b.T
        return self._replace(
            x_low=_put(self.x_low, ids, enc),
            live=_set_live(self.live, ids, True, self.n_rows,
                           self.x_low.device))

    def remove_rows(self, ids: torch.Tensor) -> "LinearScorer":
        """Tombstone slots ``ids`` (their contents stop mattering)."""
        return self._replace(live=_set_live(self.live, ids, False,
                                            self.n_rows, self.x_low.device))

    def refresh(self, model, transition=None, x_full=None,
                pending=None) -> "LinearScorer":
        """Re-encode under a refreshed ``model``: the Eq. 12 ``transition``
        over the STORED reduced vectors, or exactly from ``x_full``.
        ``pending`` ((n,) bool) selects a lazy subset; the other rows keep
        their old projection."""
        if self.a is None:
            return self     # the exact scorer stores the raw vectors
        if x_full is not None:
            new_low = x_full.to(torch.float32) @ model.b.T
        else:
            new_low = self.x_low @ transition.T
        if pending is not None:
            new_low = torch.where(pending[:, None], new_low, self.x_low)
        return self._replace(x_low=new_low, a=model.a)

    def encode_centers(self, centers: torch.Tensor,
                       model=None) -> "LinearScorer":
        """Probe companion over full-D ``centers`` (C, D): scored with this
        scorer's qstate it gives <Aq, B c> (the raw centers when
        ``a=None``)."""
        c = centers.to(torch.float32)
        if self.a is None:
            return LinearScorer(x_low=c)
        if model is None:
            raise ValueError("encode_centers on a reduced LinearScorer "
                             "needs the DR model (its B matrix)")
        return LinearScorer(x_low=c @ model.b.T)


class GleanVecScorer(NamedTuple):
    """Eager GleanVec scoring (Alg. 4): tag-selected per-cluster views."""

    x_low: torch.Tensor                 # (n, d) = B_{tag_i} x_i
    tags: torch.Tensor                  # (n,) int32
    a: Optional[torch.Tensor] = None    # (C, d, D)
    live: Optional[torch.Tensor] = None  # (n,) bool slot mask (None = all)

    @property
    def n_rows(self) -> int:
        return self.x_low.shape[0]

    def prepare_queries(self, queries: torch.Tensor) -> torch.Tensor:
        if self.a is None:
            raise ValueError("GleanVecScorer without `a` cannot prepare "
                             "queries; pass precomputed (m, C, d) views")
        return _views(self.a, queries)

    def score_block(self, qstate: torch.Tensor, start: int,
                    block: int) -> torch.Tensor:
        tag = self.tags[start:start + block].long()
        return _mask_live_block(self.live, start, block, torch.einsum(
            "mbd,bd->mb", qstate[:, tag, :], self.x_low[start:start + block]))

    def score_ids(self, qstate: torch.Tensor, ids: torch.Tensor):
        ids = ids.long()
        q_sel = _gather_views(qstate, self.tags[ids].long())   # (m, p, d)
        return _mask_live_ids(self.live, ids,
                              torch.sum(q_sel * self.x_low[ids], dim=-1))

    def translate_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return _translate_live(self.live, self.n_rows, ids)

    def shard_rows(self, s: int, n_shards: int) -> "GleanVecScorer":
        return _shard_leaves(self, s, n_shards, ("x_low", "tags", "live"))

    def globalize_ids(self, ids: torch.Tensor, shard_idx) -> torch.Tensor:
        return _globalize_row_aligned(ids, shard_idx, self.n_rows)

    # ---- streaming row-level ops (Section 3.2) ----

    def insert_rows(self, ids: torch.Tensor, rows: torch.Tensor,
                    model=None) -> "GleanVecScorer":
        tags_new, enc = gv.encode_database(model, rows)
        return self._replace(
            x_low=_put(self.x_low, ids, enc),
            tags=_put(self.tags, ids, tags_new),
            live=_set_live(self.live, ids, True, self.n_rows,
                           self.x_low.device))

    def remove_rows(self, ids: torch.Tensor) -> "GleanVecScorer":
        return self._replace(live=_set_live(self.live, ids, False,
                                            self.n_rows, self.x_low.device))

    def refresh(self, model, transition=None, x_full=None,
                pending=None) -> "GleanVecScorer":
        """Per-cluster Eq. 12: row i maps through T_{tag_i} ((C, d, d)
        ``transition``), or re-encodes exactly from ``x_full``; one product
        per cluster. Tags are untouched (the landmarks are fixed under
        streaming)."""
        if x_full is not None:
            new_low = gv.project_per_cluster(x_full, self.tags, model.b)
        else:
            new_low = gv.project_per_cluster(self.x_low, self.tags,
                                             transition)
        if pending is not None:
            new_low = torch.where(pending[:, None], new_low, self.x_low)
        return self._replace(x_low=new_low, a=model.a)

    def encode_centers(self, centers: torch.Tensor,
                       model=None) -> "GleanVecScorer":
        return _center_views_scorer(centers, model)


class QuantizedScorer(NamedTuple):
    """Int8 SQ over linearly reduced vectors, per-dimension affine scales
    folded into the query: <q, u*delta + lo> = <q*delta, u> + <q, lo>."""

    codes: torch.Tensor                 # (n, d) uint8
    lo: torch.Tensor                    # (d,)
    delta: torch.Tensor                 # (d,)
    a: Optional[torch.Tensor] = None    # (d, D)
    live: Optional[torch.Tensor] = None  # (n,) bool slot mask (None = all)

    @property
    def n_rows(self) -> int:
        return self.codes.shape[0]

    def prepare_queries(self, queries: torch.Tensor) -> QuantQueryState:
        q = queries.to(torch.float32)
        if self.a is not None:
            q = q @ self.a.T
        return QuantQueryState(q_scaled=q * self.delta[None, :],
                               q_lo=q @ self.lo)

    def score_block(self, qstate: QuantQueryState, start: int,
                    block: int) -> torch.Tensor:
        c = self.codes[start:start + block].to(torch.float32)
        return _mask_live_block(self.live, start, block,
                                qstate.q_scaled @ c.T + qstate.q_lo[:, None])

    def score_ids(self, qstate: QuantQueryState, ids: torch.Tensor):
        c = self.codes[ids.long()].to(torch.float32)   # (m, p, d)
        return _mask_live_ids(self.live, ids,
                              torch.einsum("mpd,md->mp", c, qstate.q_scaled)
                              + qstate.q_lo[:, None])

    def translate_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return _translate_live(self.live, self.n_rows, ids)

    def shard_rows(self, s: int, n_shards: int) -> "QuantizedScorer":
        return _shard_leaves(self, s, n_shards, ("codes", "live"))

    def globalize_ids(self, ids: torch.Tensor, shard_idx) -> torch.Tensor:
        return _globalize_row_aligned(ids, shard_idx, self.n_rows)

    # ---- streaming row-level ops (Section 3.2) ----

    def insert_rows(self, ids: torch.Tensor, rows: torch.Tensor,
                    model=None) -> "QuantizedScorer":
        """Code new rows under the EXISTING scales (clipped if they fall
        outside the fitted range); the next ``refresh`` refits them."""
        rows = rows.to(torch.float32)
        low = rows if self.a is None else rows @ model.b.T
        return self._replace(
            codes=_put(self.codes, ids, _code_rows(low, self.lo[None, :],
                                                   self.delta[None, :])),
            live=_set_live(self.live, ids, True, self.n_rows,
                           self.codes.device))

    def remove_rows(self, ids: torch.Tensor) -> "QuantizedScorer":
        return self._replace(live=_set_live(self.live, ids, False,
                                            self.n_rows, self.codes.device))

    def refresh(self, model, transition=None, x_full=None,
                pending=None) -> "QuantizedScorer":
        """Dequantize, Eq. 12 reproject (or re-encode from ``x_full``),
        requantize with scales fitted over the live rows."""
        old_low = quant.dequantize(quant.SQDatabase(self.codes, self.lo,
                                                    self.delta))
        if x_full is not None:
            new_low = x_full.to(torch.float32) @ model.b.T
        else:
            new_low = old_low @ transition.T
        if pending is not None:
            new_low = torch.where(pending[:, None], new_low, old_low)
        db = quant.quantize(new_low, valid=self.live)
        return self._replace(codes=db.codes, lo=db.lo, delta=db.delta,
                             a=model.a)

    def encode_centers(self, centers: torch.Tensor,
                       model=None) -> "QuantizedScorer":
        """Probe companion consuming the folded-scale qstate: the centers
        as f32 pseudo-codes ``(Bc - lo) / delta`` (not rounded), so
        ``q_scaled @ codes + q_lo == <Aq, Bc>``."""
        if model is None:
            raise ValueError("encode_centers on a QuantizedScorer needs "
                             "the DR model (its B matrix)")
        low = centers.to(torch.float32) @ model.b.T
        return QuantizedScorer(codes=(low - self.lo[None, :])
                               / self.delta[None, :],
                               lo=self.lo, delta=self.delta)


class GleanVecQuantizedScorer(NamedTuple):
    """GleanVec o int8: per-cluster int8 codes of B_c x, affine terms folded
    into the eager query views."""

    codes: torch.Tensor                 # (n, d) uint8
    tags: torch.Tensor                  # (n,) int32
    lo: torch.Tensor                    # (C, d)
    delta: torch.Tensor                 # (C, d)
    a: torch.Tensor                     # (C, d, D)
    live: Optional[torch.Tensor] = None  # (n,) bool slot mask (None = all)

    @property
    def n_rows(self) -> int:
        return self.codes.shape[0]

    def prepare_queries(self, queries: torch.Tensor) -> QuantQueryState:
        qv = _views(self.a, queries)                       # (m, C, d)
        return QuantQueryState(q_scaled=qv * self.delta[None],
                               q_lo=(qv * self.lo[None]).sum(dim=-1))

    def score_block(self, qstate: QuantQueryState, start: int,
                    block: int) -> torch.Tensor:
        tag = self.tags[start:start + block].long()
        c = self.codes[start:start + block].to(torch.float32)
        return _mask_live_block(
            self.live, start, block,
            torch.einsum("mbd,bd->mb", qstate.q_scaled[:, tag, :], c)
            + qstate.q_lo[:, tag])

    def score_ids(self, qstate: QuantQueryState, ids: torch.Tensor):
        ids = ids.long()
        tag = self.tags[ids].long()                        # (m, p)
        c = self.codes[ids].to(torch.float32)              # (m, p, d)
        q_sel = _gather_views(qstate.q_scaled, tag)
        return _mask_live_ids(self.live, ids, torch.sum(q_sel * c, dim=-1)
                              + torch.gather(qstate.q_lo, 1, tag))

    def translate_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return _translate_live(self.live, self.n_rows, ids)

    def shard_rows(self, s: int, n_shards: int) -> "GleanVecQuantizedScorer":
        return _shard_leaves(self, s, n_shards, ("codes", "tags", "live"))

    def globalize_ids(self, ids: torch.Tensor, shard_idx) -> torch.Tensor:
        return _globalize_row_aligned(ids, shard_idx, self.n_rows)

    # ---- streaming row-level ops (Section 3.2) ----

    def insert_rows(self, ids: torch.Tensor, rows: torch.Tensor,
                    model=None) -> "GleanVecQuantizedScorer":
        """Tag, project and code new rows under the EXISTING per-cluster
        scales (clipped); the next ``refresh`` refits them."""
        tags_new, low = gv.encode_database(model, rows)
        t = tags_new.long()
        return self._replace(
            codes=_put(self.codes, ids,
                       _code_rows(low, self.lo[t], self.delta[t])),
            tags=_put(self.tags, ids, tags_new),
            live=_set_live(self.live, ids, True, self.n_rows,
                           self.codes.device))

    def remove_rows(self, ids: torch.Tensor) -> "GleanVecQuantizedScorer":
        return self._replace(live=_set_live(self.live, ids, False,
                                            self.n_rows, self.codes.device))

    def refresh(self, model, transition=None, x_full=None,
                pending=None) -> "GleanVecQuantizedScorer":
        """Per-cluster dequantize, T_tag reprojection (or exact re-encode
        from ``x_full``), per-cluster requantize over the live rows."""
        t = self.tags.long()
        old_low = self.codes.to(torch.float32) * self.delta[t] + self.lo[t]
        if x_full is not None:
            new_low = gv.project_per_cluster(x_full, self.tags, model.b)
        else:
            new_low = gv.project_per_cluster(old_low, self.tags, transition)
        if pending is not None:
            new_low = torch.where(pending[:, None], new_low, old_low)
        db = quant.quantize_per_cluster(new_low, self.tags,
                                        self.lo.shape[0], valid=self.live)
        return self._replace(codes=db.codes, lo=db.lo, delta=db.delta,
                             a=model.a)

    def encode_centers(self, centers: torch.Tensor,
                       model=None) -> "GleanVecQuantizedScorer":
        return _center_pseudo_scorer(centers, model, self.lo, self.delta,
                                     self.a)


def _sorted_insert(scorer, field: str, ids, enc, tags_new):
    """The sorted layouts' ``insert_rows``: claim slots in the new rows'
    clusters (releasing re-inserted ids' old slots) and write ``enc`` into
    ``field`` there. The layout's shape never changes."""
    ids = ids.long()
    slots, freed = _sorted_claim_slots(scorer.perm, scorer.inv_perm,
                                       scorer.block_tags,
                                       scorer.layout_block, ids, tags_new)
    perm = _put(scorer.perm, freed, -1) if freed.numel() else scorer.perm
    return scorer._replace(**{
        field: _put(getattr(scorer, field), slots, enc),
        "perm": _put(perm, slots, ids),
        "inv_perm": _put(scorer.inv_perm, ids, slots)})


def _sorted_remove(scorer, ids):
    ids = ids.long()
    slots = scorer.inv_perm[ids].long()
    slots = slots[slots >= 0]
    return scorer._replace(perm=_put(scorer.perm, slots, -1),
                           inv_perm=_put(scorer.inv_perm, ids, -1))


def _sorted_refresh_low(scorer, old_low, model, transition, x_full,
                        pending, zero_padding: bool):
    """New reduced rows of a sorted layout: per cluster over its blocks
    (every block has one tag), T_c over ``old_low`` or B_c over the rows'
    full-precision vectors (padding rows read row 0, and are set to 0 with
    ``zero_padding``, as the reference's f32 layout does)."""
    row_tags = scorer.row_tags
    valid = scorer.perm >= 0
    safe = torch.where(valid, scorer.perm, torch.zeros_like(scorer.perm))
    if x_full is not None:
        new_low = gv.project_per_cluster(x_full, row_tags, model.b,
                                         src=safe.long())
        if zero_padding:
            new_low = torch.where(valid[:, None], new_low,
                                  torch.zeros_like(new_low))
    else:
        new_low = gv.project_per_cluster(old_low, row_tags, transition)
    if pending is not None:
        p_rows = valid & pending[safe.long()]
        new_low = torch.where(p_rows[:, None], new_low, old_low)
    return new_low, valid


class SortedGleanVecScorer(NamedTuple):
    """Eager GleanVec over a tag-sorted, cluster-padded database: every
    ``layout_block`` rows share one tag."""

    x_low: torch.Tensor                 # (ns, d) sorted rows
    block_tags: torch.Tensor            # (ns // layout_block,) int32
    perm: torch.Tensor                  # (ns,) sorted row -> original id
    inv_perm: torch.Tensor              # (n,) original id -> sorted row
    a: Optional[torch.Tensor] = None    # (C, d, D)
    # (C, max_blocks) layout blocks per cluster, -1-padded (the IVF probe
    # schedule's source; None on hand-made layouts)
    list_block_ranges: Optional[torch.Tensor] = None

    @property
    def n_rows(self) -> int:
        return self.x_low.shape[0]

    @property
    def layout_block(self) -> int:
        return self.x_low.shape[0] // self.block_tags.shape[0]

    @property
    def row_tags(self) -> torch.Tensor:
        """(ns,) tag of every sorted row."""
        return torch.repeat_interleave(self.block_tags, self.layout_block)

    def prepare_queries(self, queries: torch.Tensor) -> torch.Tensor:
        if self.a is None:
            raise ValueError("SortedGleanVecScorer without `a` cannot "
                             "prepare queries; pass precomputed (m, C, d) "
                             "views")
        return _views(self.a, queries)

    def score_ids(self, qstate: torch.Tensor, ids: torch.Tensor):
        rows, tag, ok = _sorted_rows(self, ids)
        scores = torch.sum(_gather_views(qstate, tag) * self.x_low[rows],
                           dim=-1)
        return torch.where(ok, scores, torch.full_like(scores, NEG_INF))

    def scan_lists(self, qstate: torch.Tensor, probe: torch.Tensor, k: int):
        """Gather-free IVF fine step: the probed clusters' single-tag slabs
        through ``ivf_scan_topk``. ``probe (m, nprobe)`` holds cluster ids
        equal to this layout's tags (an aligned coarse quantizer). Returns
        (vals, ids) (m, k), ids ORIGINAL, -1 for -inf winners."""
        from repro_torch.kernels import scorer_scan_lists
        return scorer_scan_lists(self, qstate, probe, k)

    def scan_neighbors(self, qstate: torch.Tensor, nbr_rows: torch.Tensor,
                       beam_vals: torch.Tensor, beam_ids: torch.Tensor,
                       tn: int = 8):
        """Gather-free graph hop: fold one neighbor expansion, given as
        SORTED-ROW indices ``nbr_rows (m, S)`` (-1 = pad), into the beam
        through ``graph_scan_beam_step``. Returns the merged ``(vals, ids)
        (m, beam)`` with ORIGINAL ids."""
        from repro_torch.kernels import scorer_scan_neighbors
        return scorer_scan_neighbors(self, qstate, nbr_rows, beam_vals,
                                     beam_ids, tn)

    def encode_centers(self, centers: torch.Tensor,
                       model=None) -> "GleanVecScorer":
        """The sorted layout prepares the same (m, C, d) views as the
        row-aligned GleanVec scorer, so its companion is one too."""
        return _center_views_scorer(centers, model)

    def shard_rows(self, s: int, n_shards: int) -> "SortedGleanVecScorer":
        return _shard_sorted(self, s, n_shards, "x_low")

    def globalize_ids(self, ids: torch.Tensor, shard_idx) -> torch.Tensor:
        return ids          # perm already holds global original ids

    # ---- streaming row-level ops (Section 3.2) ----

    def insert_rows(self, ids: torch.Tensor, rows: torch.Tensor,
                    model=None) -> "SortedGleanVecScorer":
        """Claim free slots inside each new row's cluster blocks (already
        live ids release their old slot first: re-insert == overwrite)."""
        tags_new, enc = gv.encode_database(model, rows)
        return _sorted_insert(self, "x_low", ids, enc, tags_new)

    def remove_rows(self, ids: torch.Tensor) -> "SortedGleanVecScorer":
        return _sorted_remove(self, ids)

    def refresh(self, model, transition=None, x_full=None,
                pending=None) -> "SortedGleanVecScorer":
        """Per-cluster Eq. 12 over the sorted rows; padding rows stay
        masked by ``perm``."""
        new_low, _ = _sorted_refresh_low(self, self.x_low, model,
                                         transition, x_full, pending,
                                         zero_padding=True)
        return self._replace(x_low=new_low, a=model.a)


class SortedGleanVecQuantizedScorer(NamedTuple):
    """GleanVec o int8 over the tag-sorted layout (same id translation as
    :class:`SortedGleanVecScorer`)."""

    codes: torch.Tensor                 # (ns, d) uint8, sorted
    block_tags: torch.Tensor            # (ns // layout_block,) int32
    perm: torch.Tensor                  # (ns,)
    inv_perm: torch.Tensor              # (n,)
    lo: torch.Tensor                    # (C, d)
    delta: torch.Tensor                 # (C, d)
    a: torch.Tensor                     # (C, d, D)
    list_block_ranges: Optional[torch.Tensor] = None   # (C, max_blocks)

    @property
    def n_rows(self) -> int:
        return self.codes.shape[0]

    @property
    def layout_block(self) -> int:
        return self.codes.shape[0] // self.block_tags.shape[0]

    @property
    def row_tags(self) -> torch.Tensor:
        """(ns,) tag of every sorted row."""
        return torch.repeat_interleave(self.block_tags, self.layout_block)

    def prepare_queries(self, queries: torch.Tensor) -> QuantQueryState:
        qv = _views(self.a, queries)
        return QuantQueryState(q_scaled=qv * self.delta[None],
                               q_lo=(qv * self.lo[None]).sum(dim=-1))

    def score_ids(self, qstate: QuantQueryState, ids: torch.Tensor):
        rows, tag, ok = _sorted_rows(self, ids)
        c = self.codes[rows].to(torch.float32)
        scores = torch.sum(_gather_views(qstate.q_scaled, tag) * c, dim=-1) \
            + torch.gather(qstate.q_lo, 1, tag)
        return torch.where(ok, scores, torch.full_like(scores, NEG_INF))

    def scan_lists(self, qstate: QuantQueryState, probe: torch.Tensor,
                   k: int):
        """Gather-free IVF fine step over the sorted int8 codes (see
        :meth:`SortedGleanVecScorer.scan_lists`)."""
        from repro_torch.kernels import scorer_scan_lists
        return scorer_scan_lists(self, qstate, probe, k)

    def scan_neighbors(self, qstate: QuantQueryState,
                       nbr_rows: torch.Tensor, beam_vals: torch.Tensor,
                       beam_ids: torch.Tensor, tn: int = 8):
        """Gather-free graph hop over the sorted int8 codes (see
        :meth:`SortedGleanVecScorer.scan_neighbors`)."""
        from repro_torch.kernels import scorer_scan_neighbors
        return scorer_scan_neighbors(self, qstate, nbr_rows, beam_vals,
                                     beam_ids, tn)

    def encode_centers(self, centers: torch.Tensor,
                       model=None) -> "GleanVecQuantizedScorer":
        return _center_pseudo_scorer(centers, model, self.lo, self.delta,
                                     self.a)

    def shard_rows(self, s: int, n_shards: int
                   ) -> "SortedGleanVecQuantizedScorer":
        return _shard_sorted(self, s, n_shards, "codes")

    def globalize_ids(self, ids: torch.Tensor, shard_idx) -> torch.Tensor:
        return ids          # perm already holds global original ids

    # ---- streaming row-level ops (Section 3.2) ----

    def insert_rows(self, ids: torch.Tensor, rows: torch.Tensor,
                    model=None) -> "SortedGleanVecQuantizedScorer":
        """Claim free slots in the new rows' clusters; code under the
        EXISTING per-cluster scales (refit at the next refresh)."""
        tags_new, low = gv.encode_database(model, rows)
        t = tags_new.long()
        enc = _code_rows(low, self.lo[t], self.delta[t])
        return _sorted_insert(self, "codes", ids, enc, tags_new)

    def remove_rows(self, ids: torch.Tensor
                    ) -> "SortedGleanVecQuantizedScorer":
        return _sorted_remove(self, ids)

    def refresh(self, model, transition=None, x_full=None,
                pending=None) -> "SortedGleanVecQuantizedScorer":
        """Per-cluster dequantize, T_c reprojection (or exact re-encode
        from ``x_full``), per-cluster requantize; padding rows are left out
        of the refitted ranges."""
        t = self.row_tags.long()
        old_low = self.codes.to(torch.float32) * self.delta[t] + self.lo[t]
        new_low, valid = _sorted_refresh_low(self, old_low, model,
                                             transition, x_full, pending,
                                             zero_padding=False)
        db = quant.quantize_per_cluster(new_low, t, self.lo.shape[0],
                                        valid=valid)
        return self._replace(codes=db.codes, lo=db.lo, delta=db.delta,
                             a=model.a)


Scorer = Union[LinearScorer, GleanVecScorer, QuantizedScorer,
               GleanVecQuantizedScorer, SortedGleanVecScorer,
               SortedGleanVecQuantizedScorer]


# ---------------------------------------------------------------------------
# Factories: model + database -> scorer (the encode step, Alg. 1 line 0).
# ---------------------------------------------------------------------------


def exact_scorer(database: torch.Tensor) -> LinearScorer:
    """Full-precision exact MIPS (the 'full' mode / rerank oracle)."""
    return LinearScorer(x_low=database.to(torch.float32))


def linear_scorer(model, database: torch.Tensor) -> LinearScorer:
    """LeanVec-Sphering: x_low = Bx, queries mapped by A."""
    return LinearScorer(x_low=database.to(torch.float32) @ model.b.T,
                        a=model.a)


def gleanvec_scorer(model, database: torch.Tensor) -> GleanVecScorer:
    """GleanVec: tags + per-cluster reduced vectors."""
    tags, x_low = gv.encode_database(model, database)
    return GleanVecScorer(x_low=x_low, tags=tags, a=model.a)


def quantized_scorer(model, database: torch.Tensor,
                     bits: int = 8) -> QuantizedScorer:
    """LeanVec-Sphering + per-dimension int8 SQ of the reduced vectors."""
    db = quant.quantize(database.to(torch.float32) @ model.b.T, bits)
    return QuantizedScorer(codes=db.codes, lo=db.lo, delta=db.delta,
                           a=model.a)


def gleanvec_quantized_scorer(model, database: torch.Tensor,
                              bits: int = 8) -> GleanVecQuantizedScorer:
    """GleanVec + per-cluster int8 SQ of the reduced vectors."""
    tags, x_low = gv.encode_database(model, database)
    db = quant.quantize_per_cluster(x_low, tags, model.n_clusters, bits)
    return GleanVecQuantizedScorer(codes=db.codes, tags=tags, lo=db.lo,
                                   delta=db.delta, a=model.a)


def sorted_gleanvec_scorer(model, database: torch.Tensor, block: int = 4096,
                           slack_blocks: int = 0) -> SortedGleanVecScorer:
    """GleanVec in the tag-sorted layout (clusters padded to ``block``,
    plus ``slack_blocks`` free blocks each)."""
    tags, x_low = gv.encode_database(model, database)
    xs, block_tags, perm = gv.sort_by_tag(tags, x_low, block=block,
                                          slack_blocks=slack_blocks)
    return SortedGleanVecScorer(
        x_low=xs, block_tags=block_tags, perm=perm,
        inv_perm=gv.inverse_permutation(perm, x_low.shape[0]), a=model.a,
        list_block_ranges=_list_block_ranges(block_tags, model.n_clusters))


def sorted_gleanvec_quantized_scorer(model, database: torch.Tensor,
                                     block: int = 4096, bits: int = 8,
                                     slack_blocks: int = 0
                                     ) -> SortedGleanVecQuantizedScorer:
    """GleanVec + per-cluster int8 SQ in the tag-sorted layout: the same
    codes and scales as :func:`gleanvec_quantized_scorer` (quantize, then
    sort)."""
    tags, x_low = gv.encode_database(model, database)
    db = quant.quantize_per_cluster(x_low, tags, model.n_clusters, bits)
    cs, block_tags, perm = gv.sort_by_tag(tags, db.codes, block=block,
                                          slack_blocks=slack_blocks)
    return SortedGleanVecQuantizedScorer(
        codes=cs, block_tags=block_tags, perm=perm,
        inv_perm=gv.inverse_permutation(perm, x_low.shape[0]), lo=db.lo,
        delta=db.delta, a=model.a,
        list_block_ranges=_list_block_ranges(block_tags, model.n_clusters))


MODES = ("full", "sphering", "gleanvec", "sphering-int8", "gleanvec-int8",
         "gleanvec-sorted", "gleanvec-int8-sorted")


def build_scorer(mode: str, database, model=None, block: int = 4096,
                 device=None) -> Scorer:
    """Mode-string dispatch used by the serving layer. ``database`` (numpy
    or tensor) is moved to ``device`` (default: the GPU); ``block`` is the
    sorted layouts' per-cluster padding multiple."""
    dev = resolve_device(device)
    database = torch.as_tensor(database, dtype=torch.float32, device=dev)
    if mode == "full":
        return exact_scorer(database)
    if model is None:
        raise ValueError(f"mode {mode!r} needs a DR model")
    if mode == "sphering":
        return linear_scorer(model, database)
    if mode == "gleanvec":
        return gleanvec_scorer(model, database)
    if mode == "sphering-int8":
        return quantized_scorer(model, database)
    if mode == "gleanvec-int8":
        return gleanvec_quantized_scorer(model, database)
    if mode == "gleanvec-sorted":
        return sorted_gleanvec_scorer(model, database, block=block)
    if mode == "gleanvec-int8-sorted":
        return sorted_gleanvec_quantized_scorer(model, database, block=block)
    raise ValueError(f"unknown scorer mode {mode!r}; one of {MODES}")
