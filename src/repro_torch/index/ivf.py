"""IVF (inverted-file) index with padded posting lists (port of
``repro/index/ivf.py``).

Coarse quantizer = spherical k-means centers. ``IVFIndex`` implements the
Index protocol of :mod:`repro_torch.index.protocol`; posting lists hold
ORIGINAL ids, so every scorer family serves through it.

The coarse probe scores the centers in R^D, or -- after
:func:`with_reduced_centers` -- in the scorer's reduced space through a
companion scorer (``scorer.encode_centers``) that consumes the scorer's
prepared queries.

The fine step has two modes. The gathered one (:func:`_probe_and_score`)
gathers the probed posting lists and scores them with ``scorer.score_ids``
(plain PyTorch; every scorer family). When the coarse quantizer IS a
tag-sorted scorer's GleanVec clustering (:func:`build_aligned`),
``candidates`` instead takes the scorer's gather-free ``scan_lists``: the
probed clusters' slabs go through the ``ivf_scan_topk`` kernel, and no
(m, nprobe * L) candidate or score matrix is made.

Streaming stores grow the posting lists in place of fixed width:
:func:`with_list_slack` pre-allocates -1 slots, :func:`insert_ids` fills
them (on the device, one stable sort), :func:`remove_ids` frees them, and
``IVFIndex.refreshed`` re-encodes the reduced-space center companion after
a model refresh.

Sharded builds (:func:`build_sharded`, :func:`build_aligned_sharded`): one
coarse quantizer over the whole database, per-shard posting lists in LOCAL
row ids, -1-padded to a common ``max_len`` so the shards stack under
:class:`repro_torch.index.distributed.ShardedIndex`; ``globalize_ids``
lifts a shard's ids by its row offset.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import spherical_kmeans
from repro_torch.device import resolve_device
from repro_torch.index.protocol import _offset_ids
from repro_torch.index.topk import NEG_INF

__all__ = ["IVFIndex", "IVFQueryState", "build", "build_aligned",
           "build_sharded", "build_aligned_sharded",
           "with_reduced_centers", "with_list_slack", "insert_ids",
           "remove_ids", "coarse_scores", "search_scorer",
           "GATHER_BUDGET_BYTES"]

# Largest (chunk, nprobe * max_len, d) gather of the gathered fine step, in
# bytes of f32 rows plus views: the queries are scored in chunks that fit.
GATHER_BUDGET_BYTES = 1 << 30


class IVFQueryState(NamedTuple):
    """The scorer's prepared queries for the fine step, plus the full-D
    queries for the coarse probe (None when the index probes in the reduced
    space through its ``center_scorer``)."""

    qstate: Any
    q_coarse: Optional[torch.Tensor]


@dataclass(frozen=True, eq=False)
class IVFIndex:
    """Inverted-file index. ``center_scorer`` (optional) scores the C
    centers with the fine scorer's prepared queries; ``nprobe`` is the
    number of lists probed; with ``aligned_layout`` (set by
    :func:`build_aligned`) the clusters are the sorted scorer's tags and
    ``candidates`` takes the gather-free range scan."""

    centers: torch.Tensor                 # (C, D) unit coarse centroids
    lists: torch.Tensor                   # (C, max_len) int32 ids, -1 pad
    center_scorer: Any = None
    nprobe: int = 8
    aligned_layout: bool = False

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def max_len(self) -> int:
        return self.lists.shape[1]

    def prepare_queries(self, scorer, queries) -> IVFQueryState:
        q_coarse = (queries.to(torch.float32)
                    if self.center_scorer is None else None)
        return IVFQueryState(qstate=scorer.prepare_queries(queries),
                             q_coarse=q_coarse)

    def candidates(self, qstate: IVFQueryState, scorer, k: int):
        if self.aligned_layout and \
                getattr(scorer, "list_block_ranges", None) is not None:
            return _probe_and_scan(qstate, scorer, self, k)
        return _probe_and_score(qstate, scorer, self, k)

    def search(self, queries, scorer, k: int):
        return self.candidates(self.prepare_queries(scorer, queries),
                               scorer, k)

    def globalize_ids(self, scorer, ids, row_start):
        return _offset_ids(ids, row_start)

    def refreshed(self, scorer, model) -> "IVFIndex":
        """Streaming-refresh hook: the reduced-space center companion came
        from the OLD model's projections, so re-encode it under the
        refreshed scorer and model (same class, same shapes)."""
        if self.center_scorer is None:
            return self
        return dataclasses.replace(
            self, center_scorer=scorer.encode_centers(self.centers, model))


# ---------------------------------------------------------------------------
# Build.
# ---------------------------------------------------------------------------


def _pack_lists(tags: torch.Tensor, n_lists: int,
                min_len: int = 1) -> torch.Tensor:
    """Bucket row ids by tag into a (n_lists, max_len) -1-padded int32
    table: one stable argsort + bincount pass, as the reference."""
    t = tags.to(torch.int64)
    n = t.shape[0]
    counts = torch.bincount(t, minlength=n_lists)
    max_len = max(min_len, int(counts.max()) if n else min_len)
    order = torch.argsort(t, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=t.device) - starts[t[order]]
    lists = torch.full((n_lists, max_len), -1, dtype=torch.int32,
                       device=t.device)
    lists[t[order], rank] = order.to(torch.int32)
    return lists


def build(x, n_lists: int, n_iters: int = 20, nprobe: int = 8,
          generator: Optional[torch.Generator] = None, init_centers=None,
          device=None) -> IVFIndex:
    """Cluster (spherical k-means seeded from ``generator``, or started
    from ``init_centers``) and bucket the database."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    km = spherical_kmeans.fit(x, n_lists, n_iters, generator=generator,
                              init_centers=init_centers, device=dev)
    centers = km.centers.contiguous()
    tags = spherical_kmeans.assign(spherical_kmeans.normalize_rows(x),
                                   centers)
    return IVFIndex(centers=centers, lists=_pack_lists(tags, n_lists),
                    nprobe=nprobe)


def build_aligned(model, database, nprobe: int = 8,
                  device=None) -> IVFIndex:
    """IVF whose coarse quantizer IS the GleanVec model's clustering:
    posting list ``c`` holds exactly the rows a tag-sorted scorer stores in
    cluster ``c``'s blocks, the precondition of the gather-free fine step.
    The packed lists serve the gathered fine step of other scorers."""
    dev = resolve_device(device)
    x = torch.as_tensor(database, dtype=torch.float32, device=dev)
    centers = model.centers.to(dev, torch.float32).contiguous()
    tags = spherical_kmeans.assign(spherical_kmeans.normalize_rows(x),
                                   centers)
    return IVFIndex(centers=centers,
                    lists=_pack_lists(tags, model.n_clusters),
                    nprobe=min(nprobe, model.n_clusters),
                    aligned_layout=True)


def _shard_lists(tags: torch.Tensor, n_lists: int, n_shards: int):
    """Per-shard posting lists of equal contiguous row shards, in LOCAL
    ids, -1-padded to the longest shard's ``max_len``."""
    n = tags.shape[0]
    if n % n_shards:
        raise ValueError(f"n={n} not divisible by n_shards={n_shards}")
    per = n // n_shards
    packed = [_pack_lists(tags[s * per:(s + 1) * per], n_lists)
              for s in range(n_shards)]
    max_len = max(p.shape[1] for p in packed)
    return [torch.nn.functional.pad(p, (0, max_len - p.shape[1]), value=-1)
            for p in packed]


def build_sharded(x, n_lists: int, n_shards: int, n_iters: int = 20,
                  nprobe: int = 8, generator: Optional[torch.Generator] = None,
                  init_centers=None, device=None):
    """Row-sharded IVF: ONE coarse quantizer fit on the whole database (the
    centers :func:`build` fits from the same generator or start), and
    per-shard posting lists over each shard's rows in LOCAL ids.

    Every shard holds the same centers, so each probes the globally best
    ``nprobe`` lists, and the union of the shards' candidates is the
    single-device candidate set. Returns a list of ``n_shards``
    :class:`IVFIndex`."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if x.shape[0] % n_shards:
        raise ValueError(f"n={x.shape[0]} not divisible by "
                         f"n_shards={n_shards}")
    km = spherical_kmeans.fit(x, n_lists, n_iters, generator=generator,
                              init_centers=init_centers, device=dev)
    centers = km.centers.contiguous()
    tags = spherical_kmeans.assign(spherical_kmeans.normalize_rows(x),
                                   centers)
    return [IVFIndex(centers=centers, lists=lists, nprobe=nprobe)
            for lists in _shard_lists(tags, n_lists, n_shards)]


def build_aligned_sharded(model, database, n_shards: int, nprobe: int = 8,
                          device=None):
    """Per-shard :func:`build_aligned`: one shared coarse quantizer (the
    model's landmarks), per-shard posting lists in LOCAL ids, padded to a
    common ``max_len``."""
    dev = resolve_device(device)
    x = torch.as_tensor(database, dtype=torch.float32, device=dev)
    centers = model.centers.to(dev, torch.float32).contiguous()
    tags = spherical_kmeans.assign(spherical_kmeans.normalize_rows(x),
                                   centers)
    return [IVFIndex(centers=centers, lists=lists,
                     nprobe=min(nprobe, model.n_clusters),
                     aligned_layout=True)
            for lists in _shard_lists(tags, model.n_clusters, n_shards)]


def with_reduced_centers(index: IVFIndex, scorer, model=None) -> IVFIndex:
    """Project the coarse centers into ``scorer``'s reduced space: the
    probe then consumes the scorer's prepared queries (R^d)."""
    return dataclasses.replace(
        index, center_scorer=scorer.encode_centers(index.centers, model))


def with_list_slack(index: IVFIndex, extra: int) -> IVFIndex:
    """Widen every posting list by ``extra`` -1 slots (at build time: this
    changes the lists' shape), so later :func:`insert_ids` calls keep it.
    ``extra`` is per list and sets the gathered probe's width."""
    pad = torch.full((index.n_lists, extra), -1, dtype=index.lists.dtype,
                     device=index.lists.device)
    return dataclasses.replace(index,
                               lists=torch.cat([index.lists, pad], dim=1))


def insert_ids(index: IVFIndex, vecs, ids) -> IVFIndex:
    """Append external ``ids`` (full-D ``vecs``) to their nearest centers'
    lists, filling -1 slots in ascending column order (the r-th insert of
    list c takes c's r-th free slot, as the reference); the lists keep
    their shape. Raises when a list is out of slack."""
    lists = index.lists
    dev = lists.device
    x_unit = spherical_kmeans.normalize_rows(
        torch.as_tensor(vecs, dtype=torch.float32, device=dev))
    tags = spherical_kmeans.assign(x_unit,
                                   index.centers.contiguous()).long()
    ids = torch.as_tensor(ids, device=dev).to(lists.dtype)
    free = lists < 0
    need = torch.bincount(tags, minlength=index.n_lists)
    short = torch.nonzero(need > free.sum(dim=1)).squeeze(1)
    if short.numel():
        raise ValueError(
            f"posting list {int(short[0])} is full; pre-allocate slack "
            "with with_list_slack before serving streams")
    frank = torch.cumsum(free.to(torch.int64), dim=1) - 1
    rows_f, cols_f = torch.nonzero(free, as_tuple=True)
    slot_of_rank = torch.zeros_like(lists, dtype=torch.int64)
    slot_of_rank[rows_f, frank[rows_f, cols_f]] = cols_f
    order = torch.argsort(tags, stable=True)
    starts = torch.cumsum(need, 0) - need
    t = tags[order]
    rank = torch.arange(t.numel(), device=dev) - starts[t]
    lists = lists.index_put((t, slot_of_rank[t, rank]), ids[order])
    return dataclasses.replace(index, lists=lists)


def remove_ids(index: IVFIndex, ids) -> IVFIndex:
    """Drop external ``ids`` from every posting list (their slots become
    free); the lists keep their shape."""
    ids = torch.as_tensor(ids, device=index.lists.device).to(
        index.lists.dtype)
    lists = torch.where(torch.isin(index.lists, ids),
                        torch.full_like(index.lists, -1), index.lists)
    return dataclasses.replace(index, lists=lists)


# ---------------------------------------------------------------------------
# Search.
# ---------------------------------------------------------------------------


def coarse_scores(index: IVFIndex, qstate: IVFQueryState) -> torch.Tensor:
    """(m, C) query-center scores: full-D without reduced centers, else
    the companion's ``score_block`` over all C centers."""
    if index.center_scorer is None:
        return qstate.q_coarse @ index.centers.T
    return index.center_scorer.score_block(qstate.qstate, 0, index.n_lists)


def _probe(index: IVFIndex, qstate: IVFQueryState) -> torch.Tensor:
    """(m, nprobe) best lists per query; equal scores go to the smaller
    list, as ``lax.top_k``."""
    coarse = coarse_scores(index, qstate)
    return torch.sort(coarse, dim=1, descending=True,
                      stable=True).indices[:, :index.nprobe]


def _probe_and_scan(qstate: IVFQueryState, scorer, index: IVFIndex, k: int):
    """Aligned fine step: the probed clusters' sorted slabs through the
    scorer's gather-free ``scan_lists``; ``index.lists`` is never read."""
    return scorer.scan_lists(qstate.qstate, _probe(index, qstate), k)


def _slice_qstate(qstate, start: int, stop: int):
    if isinstance(qstate, tuple):
        return type(qstate)(*(t[start:stop] for t in qstate))
    return qstate[start:stop]


def _probe_and_score(qstate: IVFQueryState, scorer, index: IVFIndex,
                     k: int):
    """Gathered fine step: gather the ``nprobe`` probed lists, score them
    with ``scorer.score_ids``, -inf on padding, top ``k`` (equal scores to
    the earlier candidate, as ``lax.top_k``), -inf winners' ids stripped to
    -1. Queries go in chunks whose (chunk, nprobe * max_len, d) gathers fit
    ``GATHER_BUDGET_BYTES``; the results do not depend on the chunking."""
    probe = _probe(index, qstate)                          # (m, nprobe)
    m = probe.shape[0]
    width = probe.shape[1] * index.max_len
    leaf = qstate.qstate[0] if isinstance(qstate.qstate, tuple) \
        else qstate.qstate
    d = leaf.shape[-1]
    chunk = max(1, GATHER_BUDGET_BYTES // max(1, 2 * 4 * width * d))
    out_v, out_i = [], []
    for s in range(0, m, chunk):
        cand = index.lists[probe[s:s + chunk].long()].reshape(-1, width)
        ok = cand >= 0
        safe = torch.where(ok, cand, torch.zeros_like(cand))
        scores = scorer.score_ids(_slice_qstate(qstate.qstate, s, s + chunk),
                                  safe)
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
        if width < k:
            pad = k - width
            scores = torch.cat([scores, torch.full(
                (scores.shape[0], pad), NEG_INF, device=scores.device)], 1)
            cand = torch.cat([cand, torch.full(
                (cand.shape[0], pad), -1, dtype=cand.dtype,
                device=cand.device)], 1)
        sel = torch.sort(scores, dim=1, descending=True,
                         stable=True).indices[:, :k]
        vals = torch.gather(scores, 1, sel)
        ids = torch.gather(cand, 1, sel).to(torch.int32)
        out_v.append(vals)
        out_i.append(torch.where(vals > NEG_INF, ids,
                                 torch.full_like(ids, -1)))
    return torch.cat(out_v), torch.cat(out_i)


def search_scorer(queries, scorer, index: IVFIndex, k: int,
                  nprobe: int = 8):
    """Index-protocol search at a given ``nprobe``: ``queries (m, D)`` in
    the full dimension -> (vals, ids) (m, k)."""
    return dataclasses.replace(index, nprobe=nprobe).search(queries, scorer,
                                                            k)
