"""Serving CLI: the search service (Algorithm 1) over a synthetic
collection, with a selectable scorer mode, index and rerank tier -- the
single-device paths of ``repro/launch/serve.py``, its ``--stream``
lifecycle and its ``--frontend`` topology.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode gleanvec \
        --n 2000000 --dim 512 --d 160 --clusters 48 --batch 1024 --kappa 100
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --mode gleanvec-int8-sorted --index ivf --aligned --reduced-probe \
        --nprobe 12 --n 2000000 --dim 512 --d 160 --clusters 48 \
        --batch 1024 --kappa 100 --host-rerank
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --mode gleanvec-int8-sorted --index graph --fused-graph \
        --graph-build device --beam 128 --expand 4 --n 1000000 --dim 512 \
        --d 160 --clusters 48 --batch 1024 --kappa 100

``--index ivf`` serves an IVF index: its own k-means over ``--lists``
lists, or with ``--aligned`` (sorted modes only) the GleanVec clustering
itself, whose fine step is the gather-free ``ivf_scan_topk`` kernel;
``--reduced-probe`` scores the coarse centers in the scorer's reduced
space. ``--index graph`` serves the beam search over a graph of degree
``--graph-degree`` (+ 4 random long-range edges) built by numpy NN-descent
or on the device (``--graph-build``), with ``--beam``, ``--max-hops`` and
``--expand`` (frontier vertices per hop); ``--fused-graph`` (sorted modes)
binds it to the tag-sorted layout so a batch's whole search is one
``graph_beam_search`` launch. ``--host-rerank`` demotes the (n, D)
full-precision rerank store to pinned host memory: only the kappa
candidate rows of each query cross to the card, and the engine pipelines
that gather and copy with the next batch's scan. Runs on the GPU;
``--device cpu`` runs the kernels' plain versions at a small size. Prints
the reference's ``QPS=... p50=... p99=... recall@10=...`` line.

``--stream`` drives the Section 3.2 lifecycle (paper Eq. 11-12) under live
traffic, as the reference's ``run_stream``: the model is fit on 70 % of
the collection with in-distribution queries, the traffic is OOD, and each
of ``--cycles`` cycles serves one batch (recall@10 against the exact
top-10 over the live rows), folds it into K_Q, inserts the next slice of
rows into the fixed-capacity store (and the IVF lists, or links them into
the graph with ``graph.insert_ids``), and refits and re-encodes
(``--refresh-source``: the Eq. 12 transition or the rerank store). Every
swap is guarded (structure, version, non-finite leaves and a canary's
top-k overlap ``--min-overlap``: ``serve/lifecycle.py``) and every refresh
supervised (retry with backoff, ``stored`` -> ``full`` escalation,
degradation and recovery). ``--snapshot-dir`` persists the serving and
streaming states every cycle; ``--restore`` resumes from the newest
restorable snapshot (a template model, no refit); ``--inject-fault KIND``
drills one fault of ``faults.FAULTS`` and exits non-zero if the stack
mishandles it.

``--frontend`` serves concurrent clients through the bounded coalescing
queue of ``serve/frontend.py`` (``--queue-capacity``, ``--deadline-ms``,
requests p50 / p99 against ``--slo-ms``), with the refresh on a supervised
background worker (on the card, on its own CUDA stream); ``--inject-fault``
then drills one of ``faults.FRONTEND_FAULTS``.

``--shards N`` serves the sharded placement on the one device
(``distributed.build_sharded_index``, as the reference CLI builds it): the
rows in N equal shards, each with its own scorer and index (any
``--index``), searched one after the other and merged; ``--host-rerank``
then demotes the rerank store shard by shard. It serves the static
collection: ``--stream`` and ``--frontend`` need a single-device index.

    PYTHONPATH=src python -m repro_torch.launch.serve --shards 4 \
        --mode gleanvec-int8-sorted --index ivf --aligned --reduced-probe \
        --nprobe 12 --n 2000000 --dim 512 --d 160 --clusters 48 \
        --batch 1024 --kappa 100

    PYTHONPATH=src python -m repro_torch.launch.serve --stream \
        --mode gleanvec-int8 --n 5000 --dim 64 --d 16 --clusters 8 \
        --batch 64 --device cpu --inject-fault nan-moments
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.core import gleanvec as gv
from repro_torch.core import leanvec_sphering as lvs
from repro_torch.core import metrics, rerank_tier
from repro_torch.core import search as msearch
from repro_torch.core import streaming
from repro_torch.core.scorer import MODES
from repro_torch.data import vectors
from repro_torch.device import resolve_device
from repro_torch.index import distributed, graph, ivf
from repro_torch.serve import faults, frontend, lifecycle
from repro_torch.serve.engine import ServingEngine
from repro_torch.train import checkpoint


def fit_model(mode: str, queries, database, d: int, clusters: int, device,
              seed: int = 0):
    """The DR model a mode serves with (None for ``full``)."""
    if mode == "full":
        return None
    if mode.startswith("sphering"):
        return lvs.fit(queries, database, d, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return gv.fit(queries, database, c=clusters, d=d, generator=gen,
                  device=device)


def build_graph(args, x, scorer, device, capacity=None):
    """The graph index of ``--index graph`` over ``x``: built, configured,
    padded to ``capacity`` rows (streaming) and, with ``--fused-graph``,
    bound to the scorer's sorted layout."""
    idx = dataclasses.replace(
        graph.build(x, r=args.graph_degree, n_iters=4, seed=0,
                    method=args.graph_build, device=device),
        beam=args.beam, max_hops=args.max_hops, expand=args.expand)
    if capacity is not None:
        idx = graph.with_capacity(idx, capacity)
    if args.fused_graph:
        idx = graph.with_fused_scan(idx, scorer)
    return idx


def build_index(args, x, scorer, model, device):
    """The --index axis: an Index-protocol object (None = the flat scan)."""
    if args.index == "flat":
        return None
    if args.index == "graph":
        return build_graph(args, x, scorer, device)
    if args.aligned:
        if not args.mode.endswith("-sorted"):
            raise SystemExit("--aligned needs a sorted scorer mode "
                             "(gleanvec-sorted / gleanvec-int8-sorted)")
        idx = ivf.build_aligned(model, x, nprobe=args.nprobe, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(1)
        idx = ivf.build(x, n_lists=args.lists, nprobe=args.nprobe,
                        generator=gen, device=device)
    if args.reduced_probe:
        idx = ivf.with_reduced_centers(idx, scorer, model)
    return idx


def build_sharded(args, x, model, device):
    """``--shards``: the stacked per-shard scorers are the serving scorer
    (no global encode), behind the ``ShardedIndex`` the reference CLI
    builds; with ``--host-rerank`` the rerank store is demoted in the same
    row shards. Returns ``(artifacts, index)``."""
    try:
        index, stacked = distributed.build_sharded_index(
            args.index, args.mode, x, model, n_shards=args.shards,
            generator=torch.Generator(device=device).manual_seed(1),
            n_lists=args.lists, nprobe=args.nprobe,
            reduced_probe=args.reduced_probe, aligned=args.aligned,
            beam=args.beam, max_hops=args.max_hops, expand=args.expand,
            fused_graph=args.fused_graph,
            graph_kwargs={"r": args.graph_degree, "n_iters": 4, "seed": 0,
                          "method": args.graph_build},
            device=device)
    except ValueError as e:
        raise SystemExit(f"--shards {args.shards}: {e}")
    artifacts = msearch.SearchArtifacts(scorer=stacked, x_full=x,
                                        model=model)
    if args.host_rerank:
        artifacts = msearch.demote_rerank_tier(artifacts, shards=args.shards)
    return artifacts, index


STREAM_SORT_BLOCK = 256     # the reference CLI's sorted stream layout


def stream_slack_blocks(model, rows, block: int = STREAM_SORT_BLOCK) -> int:
    """Free blocks per cluster for a sorted stream store: the largest
    cluster's count of ``rows`` (every row the stream will insert, tagged
    under the initial model -- the landmarks do not move), in blocks, plus
    one."""
    tags = gv.assign_tags(model, rows).long()
    most = int(torch.bincount(tags, minlength=model.n_clusters).max())
    return -(-most // block) + 1


def build_stream(mode: str, x, n0: int, capacity: int, model, *,
                 index: str = "flat", nprobe: int = 12,
                 reduced_probe: bool = False, slack_blocks: int = 1,
                 list_slack: int = 0, host_rerank: bool = False,
                 device=None) -> msearch.ServingState:
    """A fixed-capacity streaming store over ``x[:n0]``
    (``streaming.build_streaming_artifacts``, the rerank store in host
    memory with ``host_rerank``) behind the flat scan, or behind an aligned
    IVF (sorted modes) widened by ``list_slack`` free slots per list,
    optionally with the reduced-space probe."""
    art = streaming.build_streaming_artifacts(
        mode, x[:n0], model, capacity=capacity, sort_block=STREAM_SORT_BLOCK,
        slack_blocks=slack_blocks, host_rerank=host_rerank, device=device)
    idx = None
    if index == "ivf":
        if not mode.endswith("-sorted"):
            raise SystemExit("--stream --index ivf needs --aligned and a "
                             "sorted scorer mode")
        idx = ivf.with_list_slack(ivf.build_aligned(model, x[:n0],
                                                    nprobe=nprobe,
                                                    device=device),
                                  list_slack)
        if reduced_probe:
            idx = ivf.with_reduced_centers(idx, art.scorer, model)
    return msearch.make_state(art, index=idx)


def live_recall(engine, queries: np.ndarray, served, k: int = 10) -> float:
    """recall@k of ``served`` ids against the exact top-k over the engine's
    live rows (on the serving device; a host store's rows through its
    gather)."""
    art = engine.state.artifacts
    live_idx = torch.nonzero(streaming.live_mask(art)).squeeze(1)
    dev = msearch.artifacts_device(art)
    rows = rerank_tier.rows(art.x_full, live_idx, dev)
    if dev.type == "cuda":
        gt = vectors.exact_topk(queries, rows, k, device=dev)
    else:
        gt = vectors.exact_topk(queries, rows.numpy(), k)
    gt = live_idx.cpu().numpy()[gt]
    return metrics.recall_at_k(served, gt)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stream_insert(engine, stream, rows, remove=None):
    """Insert ``rows`` (full-D, on the serving device) into free slots and
    the IVF lists (or link them into the graph with ``graph.insert_ids``),
    tombstone the external ids ``remove`` (their moments downdated), and
    swap the result into ``engine`` (a ``ServingEngine`` or a
    ``GuardedEngine``). Returns the updated stream state."""
    st = engine.state
    dev = msearch.artifacts_device(st.artifacts)
    arts, new_ids = streaming.insert_rows(st.artifacts, rows)
    stream = streaming.insert(stream, rows)
    index = st.index
    if isinstance(index, ivf.IVFIndex):
        index = ivf.insert_ids(index, rows, new_ids)
    elif isinstance(index, graph.GraphIndex):
        index = graph.insert_ids(index, rows, new_ids, arts.scorer,
                                 arts.x_full)
    if remove is not None:
        remove = torch.as_tensor(remove, device=dev)
        stream = streaming.remove(stream, rerank_tier.rows(arts.x_full,
                                                           remove, dev))
        arts = streaming.remove_rows(arts, remove)
        if isinstance(index, ivf.IVFIndex):
            index = ivf.remove_ids(index, remove)
    engine.swap(st._replace(artifacts=arts, index=index))
    return stream


def stream_cycle(engine, stream, rows, remove=None, source: str = "stored"):
    """One unsupervised stream cycle after serving: :func:`stream_insert`,
    then refit, re-encode from ``source`` and swap again. Returns
    ``(stream, report)`` with host-clock ms of the two halves and the
    transition's condition number."""
    dev = msearch.artifacts_device(engine.state.artifacts)
    t0 = time.perf_counter()
    stream = stream_insert(engine, stream, rows, remove)
    _sync(dev)
    t1 = time.perf_counter()
    stream = streaming.refresh(stream)
    engine.swap(streaming.refresh_state(engine.state, stream, source=source))
    _sync(dev)
    t2 = time.perf_counter()
    return stream, {"insert_ms": (t1 - t0) * 1e3,
                    "refresh_ms": (t2 - t1) * 1e3,
                    "condition": streaming.transition_condition(stream)}


def _drill_fail(msg):
    print(f"  drill FAIL: {msg}")
    raise SystemExit(1)


def _fault_drill(kind, guarded, supervisor, stream, obs, snap_dir):
    """Inject one ``--inject-fault`` kind mid-stream and check the stack
    handles it, as the reference's drill. Immediate kinds (refused swaps,
    snapshot fallback, query hardening) are checked here; deferred kinds
    (poisoned moments, a refresh exception) hand back a poisoned stream or
    a failing refresh plus a check to run after the cycle's supervised
    refresh. Returns ``(stream, refresh_fn, deferred_check)``; any
    mishandling exits 1."""
    eng = guarded.engine
    print(f"  -- injecting fault: {kind}")
    if kind == "nan-moments":
        def check(rep):
            if rep.outcome != "degraded":
                _drill_fail("poisoned moments were not degraded "
                            f"(outcome={rep.outcome})")
            if lifecycle.nonfinite_leaves(eng.state):
                _drill_fail("engine is serving non-finite state")
            print(f"  drill: refresh degraded after {rep.attempts} attempts "
                  "(still serving last-known-good) -> recovering")
        return faults.nan_moments(stream), streaming.refresh, check
    if kind == "refresh-exception":
        fn = faults.failing(streaming.refresh, n_failures=1)

        def check(rep):
            if rep.outcome != "ok" or rep.attempts < 2:
                _drill_fail("retry did not absorb the injected exception "
                            f"(outcome={rep.outcome} attempts={rep.attempts})")
            print(f"  drill PASS: refresh-exception absorbed on attempt "
                  f"{rep.attempts} (escalated={rep.escalated})")
        return stream, fn, check
    before = guarded.submit(obs)
    if kind in ("corrupt-scorer", "scramble-scorer"):
        bad = (faults.corrupt_scorer_leaf if kind == "corrupt-scorer"
               else faults.scramble_scorer_leaf)(eng.state)
        want = "non-finite" if kind == "corrupt-scorer" else "canary-overlap"
        v0, s0 = guarded.version, eng.n_swaps
        try:
            guarded.swap(bad)
            _drill_fail("corrupted state was accepted")
        except lifecycle.SwapRejected as e:
            if e.reason != want:
                _drill_fail(f"rejected for {e.reason!r}, expected {want!r}")
        if (guarded.version, eng.n_swaps) != (v0, s0):
            _drill_fail("rejected swap mutated the engine")
        if not np.array_equal(guarded.submit(obs), before):
            _drill_fail("results changed across a rejected swap")
        print(f"  drill PASS: {kind} rejected ({want}), "
              "results bit-identical")
    elif kind == "truncated-snapshot":
        d = snap_dir or tempfile.mkdtemp(prefix="snap-drill-")
        lifecycle.snapshot(d, eng.state, stream, meta={"drill": 0})
        lifecycle.snapshot(d, eng.state, stream, meta={"drill": 1})
        steps = checkpoint.available_steps(d)
        faults.truncate_snapshot(d, what="manifest")
        serving, _, got, meta = lifecycle.restore(d, eng.state, stream)
        if got != steps[-2] or meta.get("drill") != 0:
            _drill_fail(f"restore did not fall back (got step {got})")
        lifecycle.restore_into(guarded, serving)
        if not np.array_equal(guarded.submit(obs), before):
            _drill_fail("restored state is not bit-identical")
        print(f"  drill PASS: truncated step {steps[-1]} fell back to "
              f"step {got}, restored results bit-identical")
    elif kind == "poison-queries":
        res = guarded.submit(faults.poison_queries(obs))
        if not (res[0] == -1).all():
            _drill_fail("poisoned row returned fabricated ids")
        if not np.array_equal(res[1:], before[1:]):
            _drill_fail("poisoned row contaminated its batch")
        print("  drill PASS: poisoned row sanitized to -1, "
              "batch uncontaminated")
    elif kind == "wrong-dim-queries":
        try:
            guarded.submit(faults.wrong_dim_queries(obs))
            _drill_fail("wrong-dimensionality batch was accepted")
        except ValueError as e:
            print(f"  drill PASS: wrong-dim batch refused ({e})")
    else:
        raise SystemExit(f"unknown fault kind {kind!r}")
    return stream, streaming.refresh, None


def _stream_data(args, dev, name: str, n_fit: int, n_queries: int):
    """The stream's data on ``dev``, its OOD traffic, and the
    in-distribution queries the model serving at t=0 is fit on (drawn
    around the first ``n_fit`` rows)."""
    ds = vectors.make_dataset(name, n=args.n, d=args.dim,
                              n_queries=max(512, n_queries), ood=True, seed=0)
    x = torch.as_tensor(ds.database, device=dev)
    rng = np.random.default_rng(0)
    q_init = ds.database[rng.integers(0, n_fit, 1024)] \
        + 0.1 * rng.standard_normal((1024, args.dim)).astype(np.float32)
    return x, ds.queries_test, q_init


def run_stream(args, dev):
    """The ``--stream`` lifecycle (see the module docstring)."""
    n0 = int(args.n * 0.7)
    step = (args.n - n0) // args.cycles
    x, qt, q_init = _stream_data(args, dev, "serve-stream", n0,
                                 args.batch * args.cycles)
    restoring = False
    if args.restore:
        restoring = bool(checkpoint.available_steps(args.snapshot_dir))
        if not restoring:
            print(f"no snapshots under {args.snapshot_dir}; cold start")
    model = lifecycle.template_model(args.mode, args.dim, args.d,
                                     clusters=args.clusters, device=dev) \
        if restoring else fit_model(args.mode, q_init, x[:n0], args.d,
                                    args.clusters, dev)
    slack = 1
    if args.mode.endswith("-sorted"):
        slack = stream_slack_blocks(model, x[n0:])
    state = build_stream(args.mode, x, n0, args.n, model,
                         index="flat" if args.index == "graph" else args.index,
                         nprobe=args.nprobe, reduced_probe=args.reduced_probe,
                         slack_blocks=slack,
                         list_slack=4 * max(1, (args.n - n0)
                                            // args.clusters),
                         host_rerank=args.host_rerank, device=dev)
    if args.index == "graph":
        state = state._replace(index=build_graph(
            args, x[:n0], state.artifacts.scorer, dev, capacity=args.n))
    stream, cycle0 = None, 0
    if restoring:
        # the templates above gave the structure; the leaves are the
        # snapshot's
        state, stream, snap_step, meta = lifecycle.restore(
            args.snapshot_dir, state,
            lifecycle.template_stream(model, refresh_every=step))
        cycle0 = int(meta.get("cycle", -1)) + 1
        print(f"restored snapshot step {snap_step} -> resuming at cycle "
              f"{cycle0} (version {int(state.version)}, no refit)")
    engine = ServingEngine(state, k=10, kappa=args.kappa,
                           batch_size=args.batch, dim=args.dim)
    guarded = lifecycle.GuardedEngine(engine, canary_queries=qt[:args.batch],
                                      min_overlap=args.min_overlap)
    supervisor = lifecycle.RefreshSupervisor(guarded)
    if stream is None:
        stream = streaming.init_from_artifacts(state.artifacts, q_init,
                                               refresh_every=step)
    print(f"stream mode={args.mode} index={args.index} n0={n0} "
          f"capacity={args.n} D={args.dim} d={args.d} cycles={args.cycles} "
          f"inserts/cycle={step} sorted slack_blocks={slack} "
          f"(block {STREAM_SORT_BLOCK}) host_rerank={args.host_rerank} "
          f"guard(min_overlap={args.min_overlap}) device={dev}")
    drill_cycle = -1
    if args.inject_fault:
        if args.inject_fault == "nan-moments" and args.cycles - cycle0 < 2:
            raise SystemExit("--inject-fault nan-moments needs >= 2 cycles "
                             "(degrade, then the recovered swap)")
        drill_cycle = max(cycle0, min(args.cycles // 2, args.cycles - 2))
    for cycle in range(cycle0, args.cycles):
        obs = qt[(cycle * args.batch) % len(qt):][:args.batch]
        refresh_fn, deferred = streaming.refresh, None
        if cycle == drill_cycle:
            stream, refresh_fn, deferred = _fault_drill(
                args.inject_fault, guarded, supervisor, stream, obs,
                args.snapshot_dir)
        live = int(streaming.live_mask(guarded.state.artifacts).sum())
        served = guarded.submit(obs)
        supervisor.note_queries(obs)
        rec = live_recall(guarded, obs, served)
        stream = streaming.observe_queries(stream, obs)
        # the next unconsumed rows, from the live count: a restored run
        # continues where the snapshot's store left off
        rows = x[live:min(live + step, args.n)]
        t0 = time.perf_counter()
        if rows.shape[0]:
            stream = stream_insert(guarded, stream, rows)
            _sync(dev)
        t1 = time.perf_counter()
        stream, rep = supervisor.refresh_and_swap(
            stream, source=args.refresh_source, refresh_fn=refresh_fn)
        _sync(dev)
        t2 = time.perf_counter()
        if deferred is not None:
            deferred(rep)
        if rep.outcome == "degraded":
            # serve the last good state; rebuild the moments from it
            stream = supervisor.recover(stream)
        bad = lifecycle.nonfinite_leaves(guarded.state)
        if bad:
            raise SystemExit(f"SERVE INVARIANT VIOLATED: non-finite leaves "
                             f"in served state: {bad[:4]}")
        print(f"  cycle {cycle}: served {served.shape[0]} queries "
              f"recall@10={rec:.3f} live_rows="
              f"{int(streaming.live_mask(guarded.state.artifacts).sum())} "
              f"version={guarded.version} insert={(t1 - t0) * 1e3:.1f}ms "
              f"refresh={(t2 - t1) * 1e3:.1f}ms "
              f"refresh={rep.outcome}/{rep.source} cond={rep.condition:.3g} "
              f"swap_p50={np.median(engine.stats.swap_ms):.2f}ms")
        if args.snapshot_dir:
            lifecycle.snapshot(args.snapshot_dir, guarded.state, stream,
                               meta={"cycle": cycle})
    if args.inject_fault == "nan-moments":
        if supervisor.n_degraded < 1 or supervisor.n_recoveries < 1:
            _drill_fail("degrade/recover cycle did not complete")
        if supervisor.reports[-1].outcome != "ok":
            _drill_fail("post-recovery refresh did not swap")
        print("  drill PASS: nan-moments -> degraded -> recovered -> "
              "swapped")
    s, h = engine.stats, supervisor
    print(f"QPS={s.qps:.0f} p50={s.percentile_ms(50):.1f}ms "
          f"p99={s.percentile_ms(99):.1f}ms swaps={engine.n_swaps} "
          f"batch_shapes={engine.n_compiles}")
    print(f"guard: accepted={guarded.health.accepted} "
          f"rejected={guarded.health.rejected} "
          f"rollbacks={guarded.health.rollbacks} "
          f"last_overlap={guarded.health.last_overlap:.3f} | "
          f"supervisor: refreshes={h.n_refreshes} retries={h.n_retries} "
          f"escalations={h.n_escalations} degraded={h.n_degraded} "
          f"recoveries={h.n_recoveries}")


def frontend_traffic(fe, queries, n_clients=4, deadline_ms=None,
                     timeout_s=60.0):
    """Send ``queries`` one request each from ``n_clients`` client
    threads. Returns ``(results {row: ids}, rejected {row: reason})``:
    every request is served or refused, none lost."""
    results, rejected = {}, {}
    lock = threading.Lock()

    def client(rows):
        for i in rows:
            try:
                ids = fe.enqueue(queries[i],
                                 deadline_ms=deadline_ms).result(timeout_s)
                with lock:
                    results[i] = ids
            except frontend.Rejected as e:
                with lock:
                    rejected[i] = e.reason

    threads = [threading.Thread(target=client,
                                args=(range(c, len(queries), n_clients),))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s * len(queries))
    return results, rejected


def _await(cond, timeout_s=30.0, poll_s=0.01):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout_s:
            return False
        time.sleep(poll_s)
    return True


def frontend_drill(kind, batch, dim, fe, guarded, worker, refresh_fn,
                   release, qt):
    """One ``--frontend --inject-fault`` drill, as the reference's; any
    mishandling exits 1."""
    eng = guarded.engine
    print(f"  -- injecting fault: {kind}")
    if kind == "poison-burst":
        burst = faults.burst_overflow(dim, batch * 4, seed=1,
                                      poison_frac=0.25)
        bad = ~np.isfinite(burst).all(axis=1)
        res, rej = frontend_traffic(fe, burst)
        if rej:
            _drill_fail(f"in-capacity burst was rejected: {rej}")
        got = np.stack([res[i] for i in range(len(burst))])
        if not (got[bad] == -1).all():
            _drill_fail("poisoned rows returned fabricated ids")
        ref = eng.submit(burst)
        if not np.array_equal(got, ref):
            _drill_fail("burst results diverge from direct submit")
        print(f"  drill PASS: {int(bad.sum())}/{len(burst)} poisoned rows "
              "-> -1, clean rows bit-identical to submit")
    elif kind == "queue-overflow":
        cap = 8
        fe_q = frontend.ServingFrontend(guarded, capacity=cap, start=False,
                                        warmup=False)
        burst = faults.burst_overflow(dim, cap + batch, seed=2)
        admitted, n_rej = [], 0
        for q in burst:              # no dispatcher: the queue must fill
            try:
                admitted.append(fe_q.enqueue(q))
            except frontend.Rejected as e:
                if e.reason != "queue-full":
                    _drill_fail(f"overflow rejected as {e.reason!r}")
                n_rej += 1
        if n_rej != len(burst) - cap:
            _drill_fail(f"admitted {len(admitted)}/{len(burst)} past "
                        f"capacity {cap}")
        if eng.stats.n_rejected < n_rej:
            _drill_fail("rejections not counted in ServeStats")
        while fe_q.queue_depth:
            fe_q.drain_once()
        if any(f.result(5).shape != (eng.k,) for f in admitted):
            _drill_fail("admitted requests did not resolve after overflow")
        print(f"  drill PASS: {n_rej} overflow requests rejected loudly, "
              f"all {cap} admitted requests served")
    elif kind == "slow-refresh":
        n0 = worker.n_cycles
        worker.observe(qt[:batch])
        worker.request_refresh()
        res, rej = frontend_traffic(fe, qt[:batch * 2])
        if len(res) + len(rej) != batch * 2:
            _drill_fail("requests lost during slow refresh")
        if not _await(lambda: worker.n_cycles > n0):
            _drill_fail("slowed refresh never completed")
        if refresh_fn.calls < 1:
            _drill_fail("slow_refresh injector never ran")
        print(f"  drill PASS: served {len(res)} requests during a "
              f"{refresh_fn.delay_s * 1e3:.0f}ms-delayed refresh "
              f"(staleness peaked, then swap landed)")
    elif kind == "stuck-worker":
        v0 = guarded.version
        worker.observe(qt[:batch])
        worker.request_refresh()
        if not _await(lambda: refresh_fn.calls >= 1):
            _drill_fail("stuck refresh never entered")
        time.sleep(0.05)
        if not worker.stuck(0.02):
            _drill_fail("watchdog did not flag the stuck worker")
        res, rej = frontend_traffic(fe, qt[:batch * 2])
        if len(res) != batch * 2 or rej:
            _drill_fail("requests failed while the worker was stuck")
        if guarded.version != v0:
            _drill_fail("version moved while the refresh was stuck")
        release.set()
        if not _await(lambda: guarded.version > v0):
            _drill_fail("released worker never swapped")
        print(f"  drill PASS: {len(res)} requests served on the stale "
              f"state while stuck; release -> swap (version {v0} -> "
              f"{guarded.version})")
    else:
        raise SystemExit(f"unknown frontend fault kind {kind!r}")


def drill_refresh_fn(kind):
    """The refresh a frontend drill runs its worker with, and the event
    that releases a stuck one."""
    if kind == "slow-refresh":
        return faults.slow_refresh(delay_s=0.25), None
    if kind == "stuck-worker":
        release = threading.Event()
        return faults.stuck_worker(release, timeout_s=60.0), release
    return streaming.refresh, None


def run_frontend(args, dev):
    """The ``--frontend`` topology: the coalescing frontend over a guarded
    engine, the refresh on a supervised background worker, mixed ID / OOD
    traffic from concurrent clients."""
    x, qt, q_id = _stream_data(args, dev, "serve-frontend", args.n,
                               args.batch * 8)
    model = fit_model(args.mode, q_id, x, args.d, args.clusters, dev)
    state = build_stream(args.mode, x, args.n, args.n, model,
                         slack_blocks=2, host_rerank=args.host_rerank,
                         device=dev)
    engine = ServingEngine(state, k=10, kappa=args.kappa,
                           batch_size=args.batch, dim=args.dim)
    guarded = lifecycle.GuardedEngine(engine, canary_queries=qt[:args.batch],
                                      min_overlap=args.min_overlap)
    supervisor = lifecycle.RefreshSupervisor(guarded)
    stream = streaming.init_from_artifacts(state.artifacts, q_id,
                                           refresh_every=args.batch)
    refresh_fn, release = drill_refresh_fn(args.inject_fault)
    worker = frontend.RefreshWorker(supervisor, stream,
                                    source=args.refresh_source,
                                    refresh_fn=refresh_fn).start()
    fe = frontend.ServingFrontend(guarded, capacity=args.queue_capacity,
                                  default_deadline_ms=args.deadline_ms)
    shapes0 = engine.n_compiles
    print(f"frontend mode={args.mode} n={args.n} D={args.dim} d={args.d} "
          f"buckets={fe.buckets} capacity={args.queue_capacity} "
          f"deadline={args.deadline_ms}ms slo={args.slo_ms}ms "
          f"host_rerank={args.host_rerank} batch_shapes={shapes0} "
          f"device={dev}")
    try:
        # mixed ID / OOD traffic with a background refresh mid-wave
        mixed = np.empty((args.batch * 4, args.dim), np.float32)
        mixed[0::2] = q_id[:args.batch * 2]
        mixed[1::2] = qt[:args.batch * 2]
        worker.observe(mixed[:args.batch])
        background = args.inject_fault not in ("stuck-worker",
                                               "slow-refresh")
        if background:
            worker.request_refresh()
        res, rej = frontend_traffic(fe, mixed, deadline_ms=args.deadline_ms)
        if len(res) + len(rej) != len(mixed):
            raise SystemExit("TRAFFIC INVARIANT VIOLATED: requests lost "
                             f"({len(res)} served + {len(rej)} refused "
                             f"!= {len(mixed)} offered)")
        if background and not _await(lambda: worker.n_cycles >= 1):
            raise SystemExit("background refresh never completed")
        if args.inject_fault:
            frontend_drill(args.inject_fault, args.batch, args.dim, fe,
                           guarded, worker, refresh_fn, release, qt)
        bad = lifecycle.nonfinite_leaves(guarded.state)
        if bad:
            raise SystemExit(f"SERVE INVARIANT VIOLATED: non-finite leaves "
                             f"in served state: {bad[:4]}")
        final = guarded.submit(qt[:args.batch])
        if final.shape != (args.batch, engine.k):
            raise SystemExit("engine not serving after the run")
        if engine.n_compiles != shapes0:
            raise SystemExit(f"new batch shapes while serving: {shapes0} -> "
                             f"{engine.n_compiles}")
    finally:
        fe.close()
        if release is not None:
            release.set()
        stopped = worker.stop(timeout=5.0)
    s = engine.stats
    print(f"QPS={s.qps:.0f} request_p50={s.request_percentile_ms(50):.1f}ms "
          f"request_p99={s.request_percentile_ms(99):.1f}ms "
          f"(slo={args.slo_ms}ms) shed_rate={s.shed_rate:.3f} "
          f"rejected={s.n_rejected} shed={s.n_shed} "
          f"deadline_miss={s.n_deadline_miss} sanitized={s.n_sanitized}")
    print(f"worker: cycles={worker.n_cycles} degraded={worker.degraded} "
          f"staleness={worker.staleness_s:.2f}s stopped={stopped} | "
          f"swaps={engine.n_swaps} batch_shapes={engine.n_compiles}")


def _check_flags(args):
    """The reference CLI's refusals."""
    if args.inject_fault in faults.FRONTEND_FAULTS and not args.frontend:
        raise SystemExit(f"--inject-fault {args.inject_fault} is a "
                         "concurrency drill: it needs --frontend")
    if args.inject_fault in faults.FAULTS and not args.stream:
        raise SystemExit(f"--inject-fault {args.inject_fault} is a "
                         "lifecycle drill: it needs --stream")
    if args.restore and not args.snapshot_dir:
        raise SystemExit("--restore needs --snapshot-dir")
    if args.frontend:
        if args.stream:
            raise SystemExit("--frontend IS the async stream topology; "
                             "drop --stream")
        if args.mode == "full" or args.shards:
            raise SystemExit("--frontend needs a DR mode and a "
                             "single-device index")
        if args.index != "flat":
            raise SystemExit("--frontend serves the flat streaming store "
                             "(index slack/insert rides --stream)")
    elif args.stream:
        if args.mode == "full" or args.shards:
            raise SystemExit("--stream needs a DR mode and a "
                             "single-device index")
        if args.index == "ivf" and not args.aligned:
            raise SystemExit("--stream --index ivf needs --aligned")
    elif args.snapshot_dir or args.restore:
        raise SystemExit("--snapshot-dir/--restore are lifecycle flags: "
                         "they need --stream")
    if args.index == "graph" and args.fused_graph \
            and not args.mode.endswith("-sorted"):
        raise SystemExit("--fused-graph needs a sorted scorer mode "
                         "(gleanvec-sorted / gleanvec-int8-sorted)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="gleanvec", choices=list(MODES))
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--clusters", type=int, default=48)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--kappa", type=int, default=50)
    ap.add_argument("--index", default="flat",
                    choices=["flat", "ivf", "graph"])
    ap.add_argument("--lists", type=int, default=64,
                    help="IVF lists of the k-means index (not --aligned)")
    ap.add_argument("--nprobe", type=int, default=12)
    ap.add_argument("--reduced-probe", action="store_true",
                    help="IVF: score the coarse centers in the scorer's "
                         "reduced space")
    ap.add_argument("--aligned", action="store_true",
                    help="IVF over the GleanVec clustering (sorted modes): "
                         "the gather-free range-scan fine step")
    ap.add_argument("--beam", type=int, default=96,
                    help="graph beam width")
    ap.add_argument("--max-hops", type=int, default=200)
    ap.add_argument("--expand", type=int, default=1,
                    help="graph frontier vertices expanded per hop "
                         "(multi-expansion beam search; 1 = classic)")
    ap.add_argument("--graph-degree", type=int, default=24)
    ap.add_argument("--graph-build", default="numpy",
                    choices=["numpy", "device", "auto"],
                    help="graph construction: numpy NN-descent, on-device "
                         "CAGRA-style self-join, or auto (device at large n)")
    ap.add_argument("--fused-graph", action="store_true",
                    help="sorted modes: bind the graph to the tag-sorted "
                         "layout (graph.with_fused_scan) so a batch's whole "
                         "search is one graph_beam_search launch")
    ap.add_argument("--host-rerank", action="store_true",
                    help="demote the (n, D) full-precision rerank store to "
                         "pinned host memory: only the kappa candidate rows "
                         "of each query cross to the device")
    ap.add_argument("--shards", type=int, default=0,
                    help="sharded placement: the rows in this many equal "
                         "shards, each with its own scorer and index, "
                         "searched one after the other on the device")
    ap.add_argument("--stream", action="store_true",
                    help="drive the Section 3.2 observe -> insert -> "
                         "refresh -> swap lifecycle under live traffic")
    ap.add_argument("--cycles", type=int, default=3,
                    help="streaming refresh cycles (--stream)")
    ap.add_argument("--refresh-source", default="stored",
                    choices=["stored", "full"],
                    help="refresh through Eq. 12 over the stored vectors or "
                         "re-encode from the rerank store")
    ap.add_argument("--snapshot-dir", default=None,
                    help="--stream: persist the serving + streaming states "
                         "here after every cycle")
    ap.add_argument("--restore", action="store_true",
                    help="--stream: resume from the newest restorable "
                         "snapshot in --snapshot-dir (template model, no "
                         "refit); corrupted steps fall back to older ones")
    ap.add_argument("--min-overlap", type=float, default=0.3,
                    help="guarded-swap canary: refuse a candidate whose "
                         "battery top-k overlap drops below this (0: off)")
    ap.add_argument("--inject-fault", default=None,
                    choices=list(faults.FAULTS) + list(faults.FRONTEND_FAULTS),
                    help="drill one fault kind (exits non-zero on "
                         "mishandling): lifecycle kinds need --stream, "
                         "concurrency kinds need --frontend")
    ap.add_argument("--frontend", action="store_true",
                    help="bounded-queue coalescing frontend + supervised "
                         "background refresh worker (serve/frontend.py)")
    ap.add_argument("--queue-capacity", type=int, default=256,
                    help="--frontend: admission-queue bound (a full queue "
                         "rejects new requests)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="--frontend: per-request latency budget; "
                         "unmeetable budgets are rejected at enqueue, "
                         "expired ones shed at dispatch (default: none)")
    ap.add_argument("--slo-ms", type=float, default=250.0,
                    help="--frontend: the SLO the request p50/p99 are "
                         "reported against")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    _check_flags(args)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.frontend:
        run_frontend(args, dev)
        return
    if args.stream:
        run_stream(args, dev)
        return
    ds = vectors.make_dataset("serve", n=args.n, d=args.dim,
                              n_queries=512, ood=True, seed=0,
                              gt_device=dev if dev.type == "cuda" else None)
    x = torch.as_tensor(ds.database, device=dev)
    model = fit_model(args.mode, ds.queries_learn, x, args.d, args.clusters,
                      dev)
    if args.shards:
        artifacts, index = build_sharded(args, x, model, dev)
    else:
        artifacts = msearch.build_artifacts(args.mode, x, model, device=dev)
        index = build_index(args, x, artifacts.scorer, model, dev)
        if args.host_rerank:
            artifacts = msearch.demote_rerank_tier(artifacts)
    kappa = 10 if args.mode == "full" else args.kappa
    engine = ServingEngine(msearch.make_state(artifacts, index=index), k=10,
                           kappa=kappa, batch_size=args.batch, dim=args.dim)
    ids = engine.submit(ds.queries_test)
    rec = metrics.recall_at_k(ids, ds.gt[:, :10])
    s = engine.stats
    placement = f"shards={args.shards}" if args.shards else "single"
    print(f"mode={args.mode} index={args.index} placement={placement} "
          f"n={args.n} D={args.dim} d={args.d} "
          f"reduced_probe={args.reduced_probe} "
          f"host_rerank={args.host_rerank} device={dev}")
    print(f"QPS={s.qps:.0f} p50={s.percentile_ms(50):.1f}ms "
          f"p99={s.percentile_ms(99):.1f}ms recall@10={rec:.3f}")
    if args.host_rerank:
        print(f"host tier: prefetch_p50={np.median(s.prefetch_ms):.2f}ms "
              f"gather_p50={np.median(s.gather_ms):.2f}ms "
              f"host_bytes_ratio={s.host_bytes_ratio:.2f}")


if __name__ == "__main__":
    main()
