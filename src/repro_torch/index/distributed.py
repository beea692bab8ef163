"""Sharded vector search: any index x any scorer, one merge (port of
``repro/index/distributed.py``).

Two placement styles, one merge: every shard's (batch, kappa) candidate
(value, id) pairs are put side by side, shard after shard -- (batch,
shards * kappa) -- and one stable sort keeps the global top k (equal values
to the earlier shard, as ``jax.lax.top_k``).

1. **Flat, global build then row shards** (:func:`make_sharded_search_scorer`):
   a scorer built over the whole database is cut into row shards
   (``scorer.shard_rows``, views) and each shard runs the scorer's fused
   scan. The SCORER-level ``scorer.globalize_ids(ids, shard_idx)`` lifts
   its ids: the row-aligned scorers offset them by the shard's row count,
   the sorted ones already emit global ids through ``perm`` (S must divide
   the layout's block count).

2. **Any index, per-shard build** (:class:`ShardedIndex`): the rows are
   split into equal contiguous shards, each with its own scorer and
   sub-index (flat scan, posting lists over one shared coarse quantizer,
   its own graph), stacked along a leading shard axis
   (:func:`stack_shards`). Each sub-index emits LOCAL ids and the
   INDEX-level ``index.globalize_ids(scorer, ids, row_start)`` lifts them
   by the shard's row offset.

Where the reference runs the shards under ``shard_map`` over a mesh (one
tiled all-gather), the port takes a ``torch.distributed`` process group:
each rank holds its own (1, ...) slice of the stacks (or its row shard of
the scorer), scans it, lifts its ids, and one ``all_gather_into_tensor``
of the (batch, kappa) values and ids makes the (batch, S * kappa) merge
input on every rank. CUDA tensors need an NCCL group and CPU tensors a
gloo one; the port changes neither backend nor device on its own. Placement
1 needs a group, as the reference's needs a mesh. A :class:`ShardedIndex`
without one (``group=None``) runs the same per-shard searches and merge one
shard after the other on the current device
(:meth:`ShardedIndex.search_local`): the serving path of the CLI's
``--shards`` on one card. Shard offsets are added on the device, so the
loop takes no host sync of its own.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from repro_torch import tree
from repro_torch.core import rerank_tier
from repro_torch.core import scorer as sc
from repro_torch.core.scorer import LinearScorer
from repro_torch.core.search import SearchArtifacts
from repro_torch.device import resolve_device
from repro_torch.index import graph as graph_mod
from repro_torch.index import ivf as ivf_mod
from repro_torch.index.protocol import FlatIndex

__all__ = ["sharded_search", "make_sharded_search",
           "sharded_search_scorer", "make_sharded_search_scorer",
           "stack_shards", "ShardedIndex", "build_sharded_index",
           "build_sharded_artifacts"]


# ---------------------------------------------------------------------------
# The merge and the collective.
# ---------------------------------------------------------------------------


def _merge_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Global top ``k`` of (m, S * kappa) candidates laid out shard after
    shard; a stable sort gives equal values to the earlier column, as
    ``jax.lax.top_k`` over the reference's tiled all-gather."""
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    order = order[:, :k]
    return torch.gather(vals, 1, order), torch.gather(ids, 1, order)


def _group_rank(group):
    import torch.distributed as dist
    return dist.get_rank(group), dist.get_world_size(group)


def _all_gather_cols(t: torch.Tensor, group, world: int) -> torch.Tensor:
    """(m, w) on every rank -> (m, world * w), rank r's block at columns
    [r w, (r + 1) w): the reference's ``all_gather(..., axis=1,
    tiled=True)``. NCCL for CUDA tensors, gloo for CPU ones (the dry
    run's fake group for either)."""
    import torch.distributed as dist
    backend = str(dist.get_backend(group))
    want = "nccl" if t.is_cuda else "gloo"
    if want not in backend and backend != "fake":
        raise ValueError(f"{t.device.type} tensors need a {want} process "
                         f"group; this one is {backend}")
    t = t.contiguous()
    out = torch.empty((world * t.shape[0], t.shape[1]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out.view(world, t.shape[0], t.shape[1]).transpose(0, 1) \
        .reshape(t.shape[0], world * t.shape[1])


def _gathered_merge(vals, ids, group, k: int):
    _, world = _group_rank(group)
    return _merge_topk(_all_gather_cols(vals, group, world),
                       _all_gather_cols(ids, group, world), k)


# ---------------------------------------------------------------------------
# Placement 1: a globally built scorer in row shards.
# ---------------------------------------------------------------------------


def _scorer_shard_candidates(queries, scorer, shard_idx, kappa: int):
    """One row shard's fused scan, ids lifted by the scorer's contract."""
    flat = FlatIndex()
    vals, ids = flat.candidates(flat.prepare_queries(scorer, queries),
                                scorer, kappa)
    return vals, scorer.globalize_ids(ids, shard_idx)


def _scorer_search_fn(group, k: int, kappa: Optional[int]):
    kappa = kappa or k
    rank, _ = _group_rank(group)

    def fn(queries, s):
        vals, ids = _scorer_shard_candidates(queries, s, rank, kappa)
        return _gathered_merge(vals, ids, group, k)
    return fn


def make_sharded_search_scorer(group, k: int, scorer,
                               kappa: Optional[int] = None):
    """``fn(queries, scorer_rows) -> (vals, ids)`` with global ids.

    ``scorer_rows`` is this rank's row shard of the scorer
    (``scorer.shard_rows(rank, world)``): it is scanned for the whole
    (replicated) query batch, its ids lifted with
    ``scorer.globalize_ids(ids, rank)``, and the ranks' candidates merged.
    ``scorer`` (the reference's spec template) must have the shard
    contract."""
    if not hasattr(scorer, "shard_rows"):
        raise TypeError(f"{type(scorer).__name__} has no shard contract")
    return _scorer_search_fn(group, k, kappa)


def make_sharded_search(group, k: int, kappa: Optional[int] = None):
    """Linear entry point: ``fn(q_low, x_rows) -> (vals, ids)`` over exact
    inner products with ``x_rows``, this rank's rows."""
    fn = _scorer_search_fn(group, k, kappa)
    return lambda q_low, x_rows: fn(q_low, LinearScorer(x_low=x_rows))


def sharded_search(q_low, x_low, group, k: int, kappa: Optional[int] = None):
    """One-shot :func:`make_sharded_search`."""
    return make_sharded_search(group, k, kappa)(q_low, x_low)


def sharded_search_scorer(queries, scorer, group, k: int,
                          kappa: Optional[int] = None):
    """One-shot :func:`make_sharded_search_scorer` (``scorer``: this
    rank's row shard)."""
    return make_sharded_search_scorer(group, k, scorer, kappa)(queries,
                                                               scorer)


# ---------------------------------------------------------------------------
# Placement 2: any (sub-index, sub-scorer) stack.
# ---------------------------------------------------------------------------


def _pad_value(dtype: torch.dtype):
    """Signed-integer leaves (ids, permutations, posting lists, entries,
    block tags) pad with -1 -- every consumer masks negative ids -- and
    float, unsigned and bool leaves with 0 / False."""
    if dtype == torch.bool:
        return False
    if dtype.is_floating_point or dtype.is_complex:
        return 0
    return -1 if torch.iinfo(dtype).min < 0 else 0


def _stack_leaf(leaves) -> torch.Tensor:
    leaves = [torch.as_tensor(x) for x in leaves]
    first = leaves[0]
    if any(x.ndim != first.ndim or x.dtype != first.dtype for x in leaves):
        raise ValueError("shards disagree on a leaf's rank or dtype: "
                         f"{[(tuple(x.shape), x.dtype) for x in leaves]}")
    target = tuple(max(dims) for dims in zip(*[x.shape for x in leaves]))
    out = torch.full((len(leaves),) + target, _pad_value(first.dtype),
                     dtype=first.dtype, device=first.device)
    for i, x in enumerate(leaves):
        out[(i,) + tuple(slice(0, d) for d in x.shape)] = x
    return out


def stack_shards(shards: Sequence[Any]):
    """Stack per-shard trees of one structure into ONE tree whose leaves
    carry a leading shard axis, padding ragged leaves (per-shard sorted
    layouts, posting-list lengths, entry-point counts) to the largest
    shape. ``x[s]`` of a stacked leaf is shard ``s``'s, a contiguous
    view."""
    flats = [tree.flatten(s) for s in shards]
    treedef = flats[0][1]
    if any(td != treedef for _, td in flats[1:]):
        raise ValueError("shards differ in structure")
    return treedef.unflatten([_stack_leaf(col)
                              for col in zip(*[lv for lv, _ in flats])])


def _take_shard(tree_, s: int):
    """Slice shard ``s`` back out of a stacked tree (views)."""
    leaves, treedef = tree.flatten(tree_)
    return treedef.unflatten([x[s] for x in leaves])


def _keep_rank(tree_, rank: int):
    """The (1, ...) slice of ``rank`` of a stacked tree, as its own
    tensors (the other shards' memory is released)."""
    leaves, treedef = tree.flatten(tree_)
    return treedef.unflatten([x[rank:rank + 1].clone() for x in leaves])


@dataclass(frozen=True, eq=False)
class ShardedIndex:
    """Placement wrapper implementing the Index protocol over ANY index.

    ``sub_index`` holds the per-shard indexes stacked along a leading
    shard axis; the per-shard scorers are stacked the same way and passed
    as the ``scorer`` argument of ``search`` / ``candidates``. Each shard
    searches its own sub-index, lifts its local ids by its global
    ``row_starts`` offset (the sub-index's ``globalize_ids``), and the
    shards' (value, id) pairs merge into the global top k.

    Under a process group (``group``) each rank holds the (1, ...) slice
    of its own shard and the merge is an all-gather; with ``group=None``
    the shards run one after the other on one device
    (:meth:`search_local`)."""

    sub_index: Any                        # stacked leaves: (S, ...)
    row_starts: torch.Tensor              # (S,) global row offset a shard
    group: Any = None                     # torch.distributed process group

    @property
    def n_shards(self) -> int:
        return self.row_starts.shape[0]

    # ---- Index protocol ----------------------------------------------------

    def prepare_queries(self, scorer, queries):
        # replicated queries; each shard prepares them with its own scorer
        # (per-shard int8 scales enter the prepared state)
        return queries.to(torch.float32)

    def _shard_candidates(self, queries, scorer, s: int, row_start,
                          kappa: int):
        s_scorer = _take_shard(scorer, s)
        s_index = _take_shard(self.sub_index, s)
        qs = s_index.prepare_queries(s_scorer, queries)
        vals, ids = s_index.candidates(qs, s_scorer, kappa)
        return vals, s_index.globalize_ids(s_scorer, ids, row_start)

    def candidates(self, queries, scorer, k: int,
                   kappa: Optional[int] = None):
        if self.group is None:
            return self.search_local(queries, scorer, k, kappa)
        kappa = kappa or k
        rank, world = _group_rank(self.group)
        if world != self.n_shards:
            raise ValueError(f"{self.n_shards} shards on a group of {world}")
        vals, ids = self._shard_candidates(queries, scorer, 0,
                                           self.row_starts[rank], kappa)
        return _gathered_merge(vals, ids, self.group, k)

    def search(self, queries, scorer, k: int, kappa: Optional[int] = None):
        return self.candidates(self.prepare_queries(scorer, queries),
                               scorer, k, kappa)

    def search_local(self, queries, scorer, k: int,
                     kappa: Optional[int] = None):
        """The same per-shard searches and merge, one shard after the
        other on the current device."""
        kappa = kappa or k
        queries = queries.to(torch.float32)
        parts = [self._shard_candidates(queries, scorer, s,
                                        self.row_starts[s], kappa)
                 for s in range(self.n_shards)]
        return _merge_topk(torch.cat([v for v, _ in parts], 1),
                           torch.cat([i for _, i in parts], 1), k)

    def globalize_ids(self, scorer, ids, row_start):
        return ids          # candidates are already global original ids

    def refreshed(self, scorer, model) -> "ShardedIndex":
        """Streaming-refresh hook: each shard's (sub-index, sub-scorer)
        pair out of the stacks, the sub-index's own ``refreshed`` against
        ITS scorer, restacked. Every hook keeps its shapes and the shards
        were padded alike at build time, so the restacked index keeps the
        structure and every leaf's shape (the engine's swap check)."""
        local = 1 if self.group is not None else self.n_shards
        subs = []
        for s in range(local):
            s_index = _take_shard(self.sub_index, s)
            if hasattr(s_index, "refreshed"):
                s_index = s_index.refreshed(_take_shard(scorer, s), model)
            subs.append(s_index)
        return dataclasses.replace(self, sub_index=stack_shards(subs))


def build_sharded_index(kind: str, mode: str, database, model=None, *,
                        group=None, n_shards: Optional[int] = None,
                        generator: Optional[torch.Generator] = None,
                        sort_block: int = 256, n_lists: int = 32,
                        nprobe: int = 8, reduced_probe: bool = False,
                        aligned: bool = False, beam: int = 64,
                        max_hops: int = 256, expand: int = 1,
                        fused_graph: bool = False, graph_kwargs=None,
                        device=None):
    """Build a :class:`ShardedIndex` and the matching stacked scorer.

    ``kind`` in {"flat", "ivf", "graph"} x ``mode`` in ``scorer.MODES`` x
    (a process ``group`` or ``n_shards`` on one device). The rows split into
    equal contiguous shards, each with its own scorer (``build_scorer``,
    sorted layouts in blocks of ``sort_block``) and sub-index: the flat
    scan; posting lists over one coarse quantizer (k-means from
    ``generator``, or with ``aligned``, sorted modes only, the GleanVec
    clustering, whose fine step is the gather-free ``ivf_scan_topk``;
    ``reduced_probe`` projects the centers into each shard's reduced
    space); or its own graph (``graph.build`` with ``graph_kwargs``, then
    ``beam`` / ``max_hops`` / ``expand``; ``fused_graph``, sorted modes
    only, binds it to its shard's layout: one ``graph_beam_search`` launch
    a shard). Under a group every rank builds every shard, from the same
    seeds, and keeps its own slice. Returns ``(sharded_index,
    stacked_scorer)``."""
    dev = resolve_device(device)
    x = torch.as_tensor(database, dtype=torch.float32, device=dev)
    n = x.shape[0]
    if group is not None:
        n_shards = _group_rank(group)[1]
    if not n_shards:
        raise ValueError("pass a process group or an explicit n_shards")
    if n % n_shards:
        raise ValueError(f"n={n} not divisible by n_shards={n_shards}")
    if kind not in ("flat", "ivf", "graph"):
        raise ValueError(f"unknown index kind {kind!r}; "
                         "one of ('flat', 'ivf', 'graph')")
    sorted_mode = mode.endswith("-sorted")
    if kind == "ivf" and aligned and not sorted_mode:
        raise ValueError("aligned IVF sharding needs a sorted scorer mode, "
                         f"got {mode!r}")
    if kind == "graph" and fused_graph and not sorted_mode:
        raise ValueError(f"fused_graph needs a sorted scorer mode, got "
                         f"{mode!r}")
    per = n // n_shards
    rows = [x[s * per:(s + 1) * per] for s in range(n_shards)]
    scorers = [sc.build_scorer(mode, r, model, block=sort_block, device=dev)
               for r in rows]

    if kind == "flat":
        subs = [FlatIndex()] * n_shards
    elif kind == "ivf":
        if aligned:
            subs = ivf_mod.build_aligned_sharded(model, x, n_shards,
                                                 nprobe=nprobe, device=dev)
        else:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            subs = ivf_mod.build_sharded(x, n_lists, n_shards, nprobe=nprobe,
                                         generator=generator, device=dev)
        if reduced_probe:
            subs = [ivf_mod.with_reduced_centers(ix, s, model)
                    for ix, s in zip(subs, scorers)]
    else:
        gkw = dict(graph_kwargs or {})
        subs = [dataclasses.replace(graph_mod.build(r, device=dev, **gkw),
                                    beam=beam, max_hops=max_hops,
                                    expand=expand) for r in rows]
        if fused_graph:
            subs = [graph_mod.with_fused_scan(ix, s)
                    for ix, s in zip(subs, scorers)]

    row_starts = torch.arange(n_shards, dtype=torch.int32, device=dev) * per
    sub_index, stacked = stack_shards(subs), stack_shards(scorers)
    if group is not None:
        rank = _group_rank(group)[0]
        sub_index, stacked = _keep_rank(sub_index, rank), \
            _keep_rank(stacked, rank)
    return (ShardedIndex(sub_index=sub_index, row_starts=row_starts,
                         group=group), stacked)


def build_sharded_artifacts(kind: str, mode: str, database, model=None, *,
                            spill_host: bool = False, **kwargs):
    """The sharded placement with the serving surface: the sharded index
    and stacked scorer (:func:`build_sharded_index`, same keywords) in
    :class:`~repro_torch.core.search.SearchArtifacts` for ``make_state`` /
    ``ServingEngine``. ``spill_host=True`` demotes the (n, D) rerank store
    to host memory shard by shard
    (:class:`~repro_torch.core.rerank_tier.ShardedHostStore`, the index's
    row partition; pinned when the rows come from the card): the card
    keeps only the reduced codes. Returns ``(index, artifacts)``."""
    index, stacked = build_sharded_index(kind, mode, database, model,
                                         **kwargs)
    x_full = torch.as_tensor(database, dtype=torch.float32,
                             device=resolve_device(kwargs.get("device")))
    if spill_host:
        x_full = rerank_tier.demote(x_full, shards=index.n_shards)
    return index, SearchArtifacts(scorer=stacked, x_full=x_full, model=model)
