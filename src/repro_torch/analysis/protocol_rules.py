"""Protocol-layer rules: mechanical checks of the Scorer / Index /
host-tier contracts the serving stack depends on (port of
``repro/analysis/protocol_rules.py``).

The swap-without-rebuild story is a structural claim: the engine's swap
check (``ServingEngine.swap``) compares two states' structures
(:mod:`repro_torch.tree`) and every tensor's shape and dtype, so every
streaming mutation -- ``insert_rows`` / ``remove_rows`` /
``refresh_artifacts`` / ``index.refreshed`` -- must return a state of the
same structure and avals; the host rerank tier must flatten to ZERO
leaves; id translation must keep ``-1`` padding inert; index configuration
must be static structure, never a tensor leaf. These rules check each
claim directly on a small :class:`ProtocolContext`, for every scorer mode
and index kind, on the device the context is built on.

Where the port's protocol differs from the reference's, the rules hold the
port to its own protocol (``SCORER_PROTOCOL``: the methods its indexes,
lowering, streaming and placement call) and say so:

* the port's ``FlatIndex`` has no ``block``: its kernels tile the rows
  themselves (``index/protocol.py``), so ``StaticConfigInTreedef("flat",
  "block")`` skips, saying that the field does not exist;
* the sorted scorers have no ``translate_ids`` or ``score_block``: they
  hand ``perm`` to the kernels as ``row_ids``, so ids leave the kernel in
  the original space; :class:`IdTranslationContract` holds them to that
  through ``kernels.scorer_topk_prepared`` on a layout with padding slots;
* no port scorer has ``pad_rows`` or ``shard_specs``: ``shard_rows`` is the
  torch counterpart of ``shard_specs`` (row shards as views).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis.registry import Rule, RuleResult

__all__ = ["ProtocolContext", "ScorerSurface", "IdTranslationContract",
           "TreedefStableStreaming", "TreedefStableIndexRefresh",
           "LeaflessAuxHostTier", "StaticConfigInTreedef",
           "BoundedCompileCache", "SCORER_PROTOCOL", "tree_signature"]

# The scorer protocol of the port, by class: what its callers call.
# Every scorer: queries prepared (indexes), gathered ids scored (IVF's
# gathered fine step, the gathered graph), the coarse centers encoded (IVF's
# reduced probe), row shards and their id lift (placement), the streaming
# row ops. The row-aligned four also score a block of rows (the probe
# companions are row-aligned) and translate ids under a live mask (the
# lowering of a live-masked store); the sorted two scan lists (aligned IVF)
# and neighbors (fused graph).
_COMMON = ("prepare_queries", "score_ids", "encode_centers", "shard_rows",
           "globalize_ids", "insert_rows", "remove_rows", "refresh")
_ROW_ALIGNED = _COMMON + ("score_block", "translate_ids")
_SORTED = _COMMON + ("scan_lists", "scan_neighbors")
SCORER_PROTOCOL = {
    "LinearScorer": (_ROW_ALIGNED, ()),
    "GleanVecScorer": (_ROW_ALIGNED, ()),
    "QuantizedScorer": (_ROW_ALIGNED, ()),
    "GleanVecQuantizedScorer": (_ROW_ALIGNED, ()),
    "SortedGleanVecScorer": (_SORTED, ("perm", "inv_perm", "block_tags",
                                       "list_block_ranges")),
    "SortedGleanVecQuantizedScorer": (_SORTED, ("perm", "inv_perm",
                                                "block_tags",
                                                "list_block_ranges")),
}


def tree_signature(tree_):
    """(structure, leaf avals): what the engine's swap check compares --
    the structure of :mod:`repro_torch.tree` plus (shape, dtype) of every
    tensor leaf (the type name of any other leaf)."""
    from repro_torch import tree
    leaves, treedef = tree.flatten(tree_)
    return treedef, tuple((tuple(l.shape), l.dtype)
                          if isinstance(l, torch.Tensor)
                          else (type(l).__name__,) for l in leaves)


class ProtocolContext:
    """Small shared fixture: one OOD dataset, both DR models, and cached
    per-mode scorers / streaming artifacts, on ``device`` (default: the
    GPU). Built once per audit or test module (the fits dominate)."""

    def __init__(self, n: int = 512, D: int = 32, d: int = 8, c: int = 4,
                 m: int = 16, sort_block: int = 64, seed: int = 0,
                 device=None):
        from repro_torch.core import gleanvec as gv
        from repro_torch.core import leanvec_sphering as lvs
        from repro_torch.data import vectors
        from repro_torch.device import resolve_device

        self.device = resolve_device(device)
        self.n, self.D, self.d, self.c, self.m = n, D, d, c, m
        self.sort_block = sort_block
        self.seed = seed
        # learning queries >= D so K_Q has full rank (the lvs.fit warning)
        self.ds = vectors.make_dataset("analysis-protocol", n=n, d=D,
                                       n_queries=max(m, 2 * D), ood=True,
                                       seed=seed)
        self.X = torch.as_tensor(self.ds.database, device=self.device)
        self.Q = torch.as_tensor(self.ds.queries_test[:m],
                                 device=self.device)
        self.lin = lvs.fit(self.ds.queries_learn, self.X, d,
                           device=self.device)
        self.gvm = gv.fit(self.ds.queries_learn, self.X, c=c, d=d,
                          generator=self.generator(seed),
                          device=self.device)
        self._scorers = {}
        self._streaming = {}

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def model_for(self, mode: str):
        if mode == "full":
            return None
        return self.lin if mode.startswith("sphering") else self.gvm

    def scorer(self, mode: str):
        if mode not in self._scorers:
            from repro_torch.core import scorer as sc
            self._scorers[mode] = sc.build_scorer(
                mode, self.X, self.model_for(mode), block=self.sort_block,
                device=self.device)
        return self._scorers[mode]

    def streaming(self, mode: str, extra_rows: int = 32):
        if mode not in self._streaming:
            from repro_torch.core import streaming
            self._streaming[mode] = streaming.build_streaming_artifacts(
                mode, self.X, self.model_for(mode),
                capacity=self.n + extra_rows, sort_block=self.sort_block,
                slack_blocks=1, device=self.device)
        return self._streaming[mode]


class _ProtocolRule(Rule):
    family = "protocol"

    def __init__(self, mode: Optional[str] = None):
        self.mode = mode

    def _result(self, base: RuleResult) -> RuleResult:
        if self.mode:
            return base._replace(target=self.mode)
        return base


class ScorerSurface(_ProtocolRule):
    """Every scorer exposes its class's protocol surface (``SCORER_PROTOCOL``)
    -- a missing method surfaces as an AttributeError deep inside a
    traversal otherwise."""

    name = "ScorerSurface"
    contract = ("every registered scorer implements the port's protocol "
                "for its class (SCORER_PROTOCOL) and an int n_rows")

    def check(self, ctx: ProtocolContext) -> RuleResult:
        s = ctx.scorer(self.mode)
        cls = type(s).__name__
        methods, attrs = SCORER_PROTOCOL.get(cls, (_COMMON, ()))
        missing = [m for m in methods if not callable(getattr(s, m, None))]
        missing += [a for a in attrs
                    if not isinstance(getattr(s, a, None), torch.Tensor)]
        if not isinstance(getattr(s, "n_rows", None), (int, np.integer)):
            missing.append("n_rows")
        if cls not in SCORER_PROTOCOL:
            missing.append("(not a registered scorer class)")
        if missing:
            return self._result(self._fail(f"{cls} missing: {missing}"))
        return self._result(self._pass(f"{cls}: {len(methods)} methods"
                                       + (f", {len(attrs)} layout fields"
                                          if attrs else "")))


class IdTranslationContract(_ProtocolRule):
    """Ids leave a scorer in the original space with ``-1`` (padding, a
    dead slot) FIXED: through ``translate_ids`` for the row-aligned
    scorers, through the kernel's ``row_ids`` (``perm``) for the sorted
    ones, whose top-k over every slot of a padded layout returns each live
    row's original id once and ``-1`` for every padding slot; and
    ``globalize_ids`` lifts ids to global ones keeping ``-1`` fixed -- the
    convention every merge, probe schedule and rerank gather relies on."""

    name = "IdTranslationContract"
    contract = ("ids leave a scorer in the original space (translate_ids, "
                "or the kernels' row_ids) with -1 padding inert, and "
                "globalize_ids keeps -1 inert")

    def check(self, ctx: ProtocolContext) -> RuleResult:
        s = ctx.scorer(self.mode)
        dev = getattr(ctx, "device", None)
        problems = []
        if hasattr(s, "translate_ids"):
            live = 0
            ext_n = s.n_rows
            t = s.translate_ids(torch.tensor([[live, -1]], dtype=torch.int32,
                                             device=dev)).cpu()[0]
            if t[1] != -1:
                problems.append(f"translate_ids(-1) -> {int(t[1])} "
                                "(want -1)")
            if not 0 <= t[0] < ext_n:
                problems.append(f"translate_ids(live slot {live}) -> "
                                f"{int(t[0])} outside [0, {ext_n})")
            first, how = int(t[0]), f"slot {live} -> {int(t[0])}"
        else:
            first, how = self._sorted(ctx, s, problems)
        g = s.globalize_ids(torch.tensor([[max(first, 0), -1]],
                                         dtype=torch.int32,
                                         device=dev), 1).cpu()[0]
        if g[1] != -1:
            problems.append(f"globalize_ids(-1) -> {int(g[1])} (want -1)")
        if g[0] < 0:
            problems.append(f"globalize_ids mapped a live id negative: "
                            f"{int(g[0])}")
        if problems:
            return self._result(self._fail("; ".join(problems)))
        return self._result(self._pass(
            f"{how}, globalize(shard=1) -> {int(g[0])}, -1 inert"))

    @staticmethod
    def _sorted(ctx, s, problems):
        """Top-k over every slot of a sorted layout (k = its slot count):
        each live row once, by its original id, then -1 for every padding
        slot."""
        from repro_torch import kernels
        perm = s.perm.cpu()
        ext_n = s.inv_perm.shape[0]
        n_live = int((perm >= 0).sum())
        _, ids = kernels.scorer_topk_prepared(s, s.prepare_queries(ctx.Q),
                                              s.n_rows)
        ids = ids.cpu()
        for row in ids:
            real = row[row >= 0]
            if not bool(((row == -1) | ((row >= 0) & (row < ext_n))).all()):
                problems.append(f"ids outside [-1, {ext_n}): "
                                f"{row[(row < -1) | (row >= ext_n)][:4].tolist()}")
                break
            if real.numel() != n_live or \
                    torch.unique(real).numel() != n_live:
                problems.append(f"{real.numel()} real ids ("
                                f"{torch.unique(real).numel()} distinct) "
                                f"for {n_live} live rows: a padding slot "
                                "or a repeated id came out")
                break
            back = perm[s.inv_perm.cpu()[real.long()].long()]
            if not torch.equal(back, real):
                problems.append("a returned id is not the original id of "
                                "the slot that holds it")
                break
        pad = s.n_rows - n_live
        first = int(ids[0, 0])
        return first, (f"top-{s.n_rows} over {n_live} live rows and {pad} "
                       f"padding slots: live ids once, padding -1")


def _signature_problem(sig0, sig1) -> Optional[str]:
    if sig0[0] != sig1[0]:
        return f"treedef changed: {sig0[0]} -> {sig1[0]}"
    if sig0[1] != sig1[1]:
        diff = [(a, b) for a, b in zip(sig0[1], sig1[1]) if a != b]
        return f"leaf avals changed: {diff}"
    return None


class TreedefStableStreaming(_ProtocolRule):
    """The swap contract, scorer side: a full streaming round trip
    (insert rows -> remove them -> model refresh) returns artifacts with
    the SAME structure and leaf avals as the originals."""

    name = "TreedefStableStreaming"
    contract = ("insert_rows / remove_rows / refresh_artifacts preserve "
                "the artifacts' structure and every leaf's shape+dtype")

    def check(self, ctx: ProtocolContext) -> RuleResult:
        from repro_torch.core import streaming

        art = ctx.streaming(self.mode)
        sig0 = tree_signature(art)
        rows = ctx.X[:4] + 0.01
        art2, ids = streaming.insert_rows(art, rows)
        art3 = streaming.remove_rows(art2, ids)
        if art.model is not None:
            st = streaming.init_from_artifacts(art3, ctx.Q)
            art3 = streaming.refresh_artifacts(art3, streaming.refresh(st),
                                               source="full")
        bad = _signature_problem(sig0, tree_signature(art3))
        if bad:
            return self._result(self._fail(bad))
        return self._result(self._pass(
            f"{len(sig0[1])} leaves stable through insert/remove/refresh"))


class TreedefStableIndexRefresh(_ProtocolRule):
    """The swap contract, index side: ``index.refreshed(scorer, model)``
    returns a same-structure, same-aval index for every kind."""

    name = "TreedefStableIndexRefresh"
    contract = ("index.refreshed(scorer, model) is structure- and "
                "aval-preserving for flat / ivf / graph / sharded")

    def __init__(self, kind: str, mode: str = "gleanvec-sorted"):
        super().__init__(mode=f"{kind}/{mode}")
        self.kind = kind
        self.scorer_mode = mode

    def _build(self, ctx: ProtocolContext):
        from repro_torch.index import distributed, graph, ivf
        from repro_torch.index.protocol import FlatIndex

        s = ctx.scorer(self.scorer_mode)
        model = ctx.model_for(self.scorer_mode)
        dev = ctx.device
        if self.kind == "flat":
            return FlatIndex(), s, model
        if self.kind == "ivf":
            if self.scorer_mode.endswith("sorted"):
                idx = ivf.build_aligned(model, ctx.X, nprobe=2, device=dev)
            else:
                idx = ivf.with_reduced_centers(
                    ivf.build(ctx.X, n_lists=8, generator=ctx.generator(1),
                              device=dev), s, model)
            return idx, s, model
        if self.kind == "graph":
            idx = graph.build(ctx.X, r=8, seed=0, device=dev)
            if self.scorer_mode.endswith("sorted"):
                idx = graph.with_fused_scan(idx, s)
            return idx, s, model
        if self.kind == "sharded":
            idx, stacked = distributed.build_sharded_index(
                "flat", self.scorer_mode, ctx.X, model, n_shards=2,
                sort_block=ctx.sort_block, device=dev)
            return idx, stacked, model
        raise ValueError(f"unknown index kind {self.kind!r}")

    def check(self, ctx: ProtocolContext) -> RuleResult:
        idx, s, model = self._build(ctx)
        sig0 = tree_signature(idx)
        bad = _signature_problem(sig0, tree_signature(idx.refreshed(s,
                                                                    model)))
        if bad:
            return self._result(self._fail(bad))
        return self._result(self._pass(
            f"{type(idx).__name__}: {len(sig0[1])} leaves stable"))


class LeaflessAuxHostTier(Rule):
    """HostStore / ShardedHostStore are ZERO-leaf nodes of a state tree
    compared by (type, shape, dtype) -- so a content refresh keeps the
    structure while a shape change breaks it loudly -- and demote /
    promote round-trips the rows exactly."""

    name = "LeaflessAuxHostTier"
    family = "protocol"
    contract = ("the host rerank tier is a leafless tree node whose "
                "equality is the store's aval, not its contents")

    def check(self, ctx: ProtocolContext) -> RuleResult:
        from repro_torch import tree
        from repro_torch.core import rerank_tier

        x = ctx.X
        problems = []
        for shards in (0, 2):
            store = rerank_tier.demote(x, shards=shards)
            leaves, treedef = tree.flatten(store)
            name = type(store).__name__
            if leaves:
                problems.append(f"{name} has {len(leaves)} leaves")
            refreshed = rerank_tier.demote(x + 1.0, shards=shards)
            if tree.structure(refreshed) != treedef:
                problems.append(f"{name}: content refresh changed the "
                                "structure")
            smaller = rerank_tier.demote(x[:-2], shards=shards)
            if tree.structure(smaller) == treedef:
                problems.append(f"{name}: shape change did NOT change the "
                                "structure")
            back = rerank_tier.promote(store, ctx.device)
            if back.device != x.device or not torch.equal(back, x):
                problems.append(f"{name}: promote != original rows")
        if problems:
            return self._fail("; ".join(problems))
        return self._pass("HostStore & ShardedHostStore leafless, "
                          "aval-keyed, round-trip exact")


class BoundedCompileCache(Rule):
    """The frontend's bucket-shape contract: every batch the coalescer
    dispatches has a shape from the SMALL, STATIC declared bucket set, so
    the distinct batch shapes the serving step runs (``n_compiles``: in
    the reference, its jit cache) stay at ``len(buckets) <= MAX_BUCKETS``
    for the life of the process."""

    name = "BoundedCompileCache"
    family = "protocol"
    contract = ("every dispatched batch shape is a declared bucket and "
                "the engine's shape count never grows past len(buckets)")

    def check(self, ctx: ProtocolContext) -> RuleResult:
        from repro_torch.core import search as msearch
        from repro_torch.serve import frontend as fe_mod
        from repro_torch.serve.engine import ServingEngine

        arts = ctx.streaming("gleanvec-int8")
        eng = ServingEngine(msearch.make_state(arts), k=5, kappa=10,
                            batch_size=ctx.m, dim=ctx.D)
        fe = fe_mod.ServingFrontend(eng, capacity=4 * ctx.m, start=False)
        problems = []
        if len(fe.buckets) > fe_mod.MAX_BUCKETS:
            problems.append(f"{len(fe.buckets)} buckets exceed "
                            f"MAX_BUCKETS={fe_mod.MAX_BUCKETS}")
        warm = eng.n_compiles
        if warm > len(fe.buckets):
            problems.append(f"warmup ran {warm} batch shapes for "
                            f"{len(fe.buckets)} buckets")
        q = np.tile(ctx.Q.cpu().numpy(), (2, 1))
        for size in (1, 3, ctx.m - 1, ctx.m):
            for row in q[:size]:
                fe.enqueue(row)
            fe.drain_once()
        stray = fe.dispatched_shapes - set(fe.buckets)
        if stray:
            problems.append(f"dispatched shapes outside the declared "
                            f"buckets {fe.buckets}: {sorted(stray)}")
        grown = eng.n_compiles - warm
        if grown:
            problems.append(f"batch shapes grew {warm} -> "
                            f"{eng.n_compiles} after warmup")
        if problems:
            return self._fail("; ".join(problems))
        return self._pass(
            f"{len(fe.dispatched_shapes)} dispatched shapes within "
            f"buckets={fe.buckets}, shapes fixed at {warm}")


class StaticConfigInTreedef(Rule):
    """Index configuration is STATIC structure: two indexes that differ
    only in a config field have different structures (the engine refuses
    to swap one for the other instead of mis-serving), and no leaf is a
    bare python scalar."""

    name = "StaticConfigInTreedef"
    family = "protocol"
    contract = ("index config (nprobe / beam ...) lives in the structure; "
                "tensors are the only leaves")

    def __init__(self, kind, field: str):
        self.kind = kind        # "flat"/"ivf"/"graph" or make(ctx)
        self.field = field

    def _result(self, passed, evidence, skipped=False):
        kind = getattr(self.kind, "__name__", self.kind)
        return RuleResult(self.name, f"{kind}.{self.field}", passed,
                          evidence, skipped, self.family)

    def check(self, ctx: ProtocolContext) -> RuleResult:
        from repro_torch import tree
        from repro_torch.index import graph, ivf
        from repro_torch.index.protocol import FlatIndex

        if self.kind == "flat" and self.field not in {
                f.name for f in dataclasses.fields(FlatIndex)}:
            return self._result(True, (
                f"FlatIndex has no {self.field!r} field (no config field "
                "at all): the kernels tile the rows themselves "
                "(index/protocol.py)"), skipped=True)
        if callable(self.kind):
            idx = self.kind(ctx)
        elif self.kind == "flat":
            idx = FlatIndex()
        elif self.kind == "ivf":
            idx = ivf.build(ctx.X, n_lists=8, generator=ctx.generator(1),
                            device=ctx.device)
        elif self.kind == "graph":
            idx = graph.build(ctx.X, r=8, n_entries=4, seed=0,
                              device=ctx.device)
        else:
            raise ValueError(f"unknown index kind {self.kind!r}")
        base = tree.structure(idx)
        bumped = dataclasses.replace(idx, **{
            self.field: getattr(idx, self.field) + 1})
        problems = []
        if tree.structure(bumped) == base:
            problems.append(f"{type(idx).__name__}.{self.field} change kept "
                            "the structure (config leaked into leaves?)")
        scalar_leaves = [type(l).__name__ for l in tree.leaves(idx)
                         if not hasattr(l, "shape")]
        if scalar_leaves:
            problems.append(f"python-scalar leaves: {scalar_leaves}")
        if problems:
            return self._result(False, "; ".join(problems))
        return self._result(True, f"{type(idx).__name__}.{self.field} is "
                                  "structure metadata")
