"""The contract audit (port of ``repro/analysis/run.py``)::

    python -m repro_torch.analysis.run audit [--device cuda|cpu] \\
        [--out PATH] [--skip-trace]
    python -m repro_torch.analysis.run lint

Composes the three rule layers over the serving matrix -- 7 scorer modes x
{flat, IVF, graph, sharded, host-rerank} -- plus the protocol round trips
and the source lint, writes the JSON (default ``ANALYSIS_torch.json`` in
the working directory; never the reference's ``ANALYSIS.json``), and exits
non-zero on any failure that ``KNOWN_DEVIATIONS`` does not list.

Per matrix cell the audit runs the REAL serving entry point's main search
-- ``state_candidates`` (flat, IVF, graph, host-rerank), or
``ShardedIndex.search_local`` over 2 shards -- over a small twin of the
paper's shapes under :class:`~repro_torch.analysis.trace_rules.StepTrace`
and runs the trace rules on it. The forbidden dense shapes come from the
mounted scorer and index (sorted layouts pad ``n_rows``; a graph hop
scores ``expand * degree`` neighbors); the gather budget is the kappa
candidate rows a query's rerank reads (M * kappa * D * 4 B). Where the
reference traces the whole ``state_search`` the port traces the main
search, where the scan-level contracts live (the rerank's (M, kappa, D)
gather is Alg. 1's own); the flat cell also traces ``state_search`` for
host syncs, and swaps an engine's state (:class:`SwapWithoutCopy`, in
place of the reference's donation check). The matrix checks the
forbidden shapes without the peak-memory bound: at M = 8 the forbidden
buffers (0.8-35 KB) are no larger than the steps' own working sets
(28 KB on the flat path, 0.35 MB for the gathered IVF's rows on an H100),
so the peak cannot tell them apart; ``chip_smoke.py`` holds that bound at
full width, where the (1024, 2M) matrix is 8.2 GB.

Known deviations: ``KNOWN_DEVIATIONS`` maps (cell, rule) to the ROADMAP C
entry that records a contract the reference keeps and the port breaks.
The audit is strict both ways: it fails on a failure the dict does not
list, and on a listed entry whose rule was evaluated (not skipped) and
passed.

Entry points run on the GPU unless the caller passes ``device="cpu"``
(``--device cpu``); with no GPU they raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List, NamedTuple, Tuple

import torch

from repro_torch.analysis import protocol_rules, source_rules, trace_rules
from repro_torch.analysis.registry import (RuleResult, failures,
                                           results_to_json, run_rules)

SRC_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Audit-matrix shapes: the reference's scaled twin of Table 1.
N, D, D_LOW, C, M, K, KAPPA = 1024, 32, 8, 4, 8, 5, 20
SORT_BLOCK = 64
NPROBE, N_LISTS = 2, 8
BEAM, MAX_HOPS, EXPAND, GRAPH_R = 8, 16, 2, 8
GRAPH_ENTRIES = 4   # <= BEAM (the beam must hold all entry points)

TOPOLOGIES = ("flat", "ivf", "graph", "sharded", "host-rerank")

# Device kernels one main search may launch (copies and sets count): a
# scan-based step (prepare the queries, the scan and its merge, the id
# translation) within STEP_LAUNCHES, a sharded one within that a shard
# (the merge included), a graph step within it too, with exactly one
# traversal kernel. On an H100 the matrix's cells launch 2-50 kernels
# (PERF.md).
STEP_LAUNCHES = 64
TRAVERSAL_KERNEL = "graph_search_kernel"

# (cell, rule) -> the ROADMAP C entry recording a contract the port breaks
# where the reference keeps it. None is open.
KNOWN_DEVIATIONS: Dict[Tuple[str, str], str] = {}


class MatrixContext(protocol_rules.ProtocolContext):
    """Protocol fixture at the matrix's shapes + the graph the cells
    share."""

    def __init__(self, device=None):
        super().__init__(n=N, D=D, d=D_LOW, c=C, m=M,
                         sort_block=SORT_BLOCK, seed=0, device=device)
        self._graph = None

    def graph_index(self):
        if self._graph is None:
            from repro_torch.index import graph
            self._graph = graph.build(self.X, r=GRAPH_R,
                                      n_entries=GRAPH_ENTRIES, seed=0,
                                      device=self.device)
        return self._graph

    def artifacts(self, mode):
        from repro_torch.core import search as msearch
        return msearch.SearchArtifacts(scorer=self.scorer(mode),
                                       x_full=self.X,
                                       model=self.model_for(mode))


def _clone(state):
    """``state`` with every tensor leaf copied (same structure and
    avals): a state nothing else holds."""
    from repro_torch import tree
    leaves, treedef = tree.flatten(state)
    return treedef.unflatten([l.clone() if isinstance(l, torch.Tensor)
                              else l for l in leaves])


def _cell_rules(dense_dims, fused: bool, budget: int, exact=None):
    rules = [trace_rules.NoDenseScoreMatrix(*dense_dims, peak=False),
             trace_rules.NoHostSyncInStep(),
             trace_rules.LaunchBudget(budget, exact)]
    if fused:
        rules.append(trace_rules.NoGatherOnFusedPath(M * KAPPA * D * 4))
    return rules


class Cell(NamedTuple):
    """One traced cell: its results and its trace's readings."""

    results: List[RuleResult]
    trace: trace_rules.StepTrace


def _audit_cell(ctx: MatrixContext, mode: str, topo: str) -> Cell:
    """Trace one (mode, topology) cell's main search and return its rule
    results and trace."""
    from repro_torch.core import search as msearch
    from repro_torch.index import distributed, graph, ivf
    from repro_torch.serve.engine import ServingEngine

    target = f"{topo}/{mode}"
    scorer = ctx.scorer(mode)
    n_rows = scorer.n_rows
    fused = mode.endswith("sorted")
    art = ctx.artifacts(mode)
    dev = ctx.device

    def traced(fn, *args):
        return trace_rules.StepTrace.of(fn, *args, label=target)

    if topo == "flat":
        state = msearch.make_state(art)
        trace = traced(msearch.state_candidates, ctx.Q, state, KAPPA)
        res = run_rules(trace, _cell_rules((M, n_rows), fused,
                                           STEP_LAUNCHES), target=target)
        whole = traced(msearch.state_search, ctx.Q, state, K, KAPPA)
        res += run_rules(whole, [trace_rules.NoHostSyncInStep()],
                         target=f"{target}:state_search")
        engine = ServingEngine(_clone(state), k=K, kappa=KAPPA,
                               batch_size=M, dim=D)
        res += run_rules(trace_rules.SwapCase(engine, _clone(state)),
                         [trace_rules.SwapWithoutCopy()], target=target)
        return Cell(res, trace)

    if topo == "ivf":
        if fused:
            idx = ivf.build_aligned(ctx.gvm, ctx.X, nprobe=NPROBE,
                                    device=dev)
        else:
            idx = ivf.with_reduced_centers(
                ivf.build(ctx.X, n_lists=N_LISTS, nprobe=NPROBE,
                          generator=ctx.generator(1), device=dev),
                scorer, ctx.model_for(mode))
        trace = traced(msearch.state_candidates, ctx.Q,
                       msearch.make_state(art, index=idx), KAPPA)
        rules = _cell_rules((M, n_rows), fused, STEP_LAUNCHES)
        if fused:
            # the fused fine step never makes the (m, nprobe * max_len)
            # gathered score matrix
            rules.append(trace_rules.NoDenseScoreMatrix(
                M, idx.nprobe * idx.max_len, peak=False))
        return Cell(run_rules(trace, rules, target=target), trace)

    if topo == "graph":
        idx = dataclasses.replace(ctx.graph_index(), beam=BEAM,
                                  max_hops=MAX_HOPS, expand=EXPAND)
        if fused:
            idx = graph.with_fused_scan(idx, scorer)
        # every mode's traversal is one kernel launch; none makes an (m,
        # expand * degree) score matrix over the gathered neighbor rows
        rules = _cell_rules((M, n_rows), fused, STEP_LAUNCHES,
                            exact={TRAVERSAL_KERNEL: 1})
        rules.append(trace_rules.NoDenseScoreMatrix(
            M, EXPAND * idx.neighbors.shape[1], peak=False))
        trace = traced(msearch.state_candidates, ctx.Q,
                       msearch.make_state(art, index=idx), KAPPA)
        return Cell(run_rules(trace, rules, target=target), trace)

    if topo == "sharded":
        idx, stacked = distributed.build_sharded_index(
            "flat", mode, ctx.X, ctx.model_for(mode), n_shards=2,
            sort_block=SORT_BLOCK, device=dev)
        trace = traced(idx.search_local, ctx.Q, stacked, K, KAPPA)
        per = distributed._take_shard(stacked, 0).n_rows
        rules = _cell_rules((M, n_rows), fused,
                            idx.n_shards * STEP_LAUNCHES)
        rules.append(trace_rules.NoDenseScoreMatrix(M, per, peak=False))
        return Cell(run_rules(trace, rules, target=target), trace)

    if topo == "host-rerank":
        state = msearch.make_state(msearch.demote_rerank_tier(art))
        trace = traced(msearch.state_candidates, ctx.Q, state, KAPPA)
        rules = _cell_rules((M, n_rows), fused, STEP_LAUNCHES)
        if mode != "full":
            # the demoted (n, D) store never comes back to the device in
            # the main search ("full" scores in R^D by design)
            rules.append(trace_rules.NoDenseScoreMatrix(
                N, D, dtypes=("f32",), peak=False))
        return Cell(run_rules(trace, rules, target=target), trace)

    raise ValueError(f"unknown topology {topo!r}")


def source_rule_set():
    return [source_rules.NoIsinstanceDispatch(),
            source_rules.NoHostSyncInStep()]


def protocol_rule_set(modes):
    rules = []
    for mode in modes:
        rules += [protocol_rules.ScorerSurface(mode),
                  protocol_rules.IdTranslationContract(mode),
                  protocol_rules.TreedefStableStreaming(mode)]
    rules += [protocol_rules.TreedefStableIndexRefresh("flat"),
              protocol_rules.TreedefStableIndexRefresh("ivf"),
              protocol_rules.TreedefStableIndexRefresh(
                  "ivf", mode="gleanvec"),
              protocol_rules.TreedefStableIndexRefresh("graph"),
              protocol_rules.TreedefStableIndexRefresh("sharded"),
              protocol_rules.LeaflessAuxHostTier(),
              protocol_rules.BoundedCompileCache(),
              protocol_rules.StaticConfigInTreedef("flat", "block"),
              protocol_rules.StaticConfigInTreedef("ivf", "nprobe"),
              protocol_rules.StaticConfigInTreedef("graph", "beam")]
    return rules


def run_lint(root: str = SRC_ROOT):
    tree = source_rules.SourceTree(root)
    return run_rules(tree, source_rule_set(), target="src/repro_torch")


def verdict(results, known=None):
    """(unlisted failures, stale listings): failures ``known`` (default
    ``KNOWN_DEVIATIONS``) does not list, and listed (cell, rule) pairs
    whose rule was evaluated here and passed."""
    known = KNOWN_DEVIATIONS if known is None else known
    unlisted = [r for r in failures(results)
                if (r.target, r.rule) not in known]
    stale = sorted({(r.target, r.rule) for r in results
                    if (r.target, r.rule) in known and r.passed
                    and not r.skipped})
    return unlisted, stale


class AuditReport(NamedTuple):
    """``code``: the exit code (0: every failure listed and every listing
    still failing); ``cells``: {cell: its StepTrace}."""

    code: int
    results: List[RuleResult]
    cells: Dict[str, trace_rules.StepTrace]
    unlisted: List[RuleResult]
    stale: List[Tuple[str, str]]


def run_audit(out: str = "ANALYSIS_torch.json", device=None,
              skip_trace: bool = False, log=print) -> AuditReport:
    """The whole audit on ``device`` (default: the GPU). Writes the JSON to
    ``out`` unless it is None."""
    from repro_torch.core.scorer import MODES
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch import kernels
        kernels.build()     # every source at once, before the first cell
    results = list(run_lint())
    log(f"[audit] source lint: {len(results)} rules")

    ctx = MatrixContext(device=dev)
    results += run_rules(ctx, protocol_rule_set(MODES))
    log(f"[audit] protocol rules done ({len(results)} total)")

    cells: Dict[str, trace_rules.StepTrace] = {}
    if not skip_trace:
        for mode in MODES:
            for topo in TOPOLOGIES:
                cell = _audit_cell(ctx, mode, topo)
                target = f"{topo}/{mode}"
                cells[target] = cell.trace
                bad = failures(cell.results)
                t = cell.trace
                log(f"[audit] {target}: {'FAIL' if bad else 'ok'} "
                    f"(ops {len(t.ops)}, syncs {t.syncs}, kernels "
                    f"{t.n_kernels}, peak above start {t.peak_bytes} B)")
                results += cell.results

    unlisted, stale = verdict(results)
    payload = results_to_json(
        results, torch_version=torch.__version__, device=dev.type,
        device_name=(torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else "cpu"),
        matrix={"modes": list(MODES),
                "topologies": [] if skip_trace else list(TOPOLOGIES),
                "cells": len(cells)},
        known_deviations=[{"target": c, "rule": r, "entry": e}
                          for (c, r), e in sorted(KNOWN_DEVIATIONS.items())],
        unlisted_failures=len(unlisted), stale_deviations=len(stale))
    if out is not None:
        with open(out, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
    counts = payload["counts"]
    log(f"[audit] {counts['passed']} passed, {counts['failed']} failed, "
        f"{counts['skipped']} skipped over {len(cells)} cells"
        + (f" -> {out}" if out else ""))
    for r in failures(results):
        listed = KNOWN_DEVIATIONS.get((r.target, r.rule))
        mark = f"listed ({listed})" if listed else "UNLISTED"
        log(f"[audit] FAIL {r.rule}[{r.target}] {mark}: {r.evidence}")
    for c, r in stale:
        log(f"[audit] STALE listing {r}[{c}]: the rule passes here")
    code = 1 if unlisted or stale else 0
    return AuditReport(code, results, cells, unlisted, stale)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.run",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ap_audit = sub.add_parser("audit", help="the three-layer audit")
    ap_audit.add_argument("--out", default="ANALYSIS_torch.json")
    ap_audit.add_argument("--skip-trace", action="store_true",
                          help="protocol + source layers only (no matrix)")
    ap_lint = sub.add_parser("lint", help="AST source lint only")
    for p in (ap_audit, ap_lint):
        p.add_argument("--device", default=None,
                       help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    if args.cmd == "lint":
        results = run_lint()
        for r in results:
            mark = "FAIL" if (not r.passed and not r.skipped) else "ok"
            print(f"[lint] {mark} {r.rule}: {r.evidence}")
        return 1 if failures(results) else 0
    return run_audit(out=args.out, device=args.device,
                     skip_trace=args.skip_trace).code


if __name__ == "__main__":
    sys.exit(main())
