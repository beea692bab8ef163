"""Serving CLI: the search service (Algorithm 1) over a synthetic
collection, with a selectable scorer mode and index -- the single-device
flat, IVF and graph paths of ``repro/launch/serve.py``, and its
``--stream`` lifecycle.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode gleanvec \
        --n 2000000 --dim 512 --d 160 --clusters 48 --batch 1024 --kappa 100
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --mode gleanvec-int8-sorted --index ivf --aligned --reduced-probe \
        --nprobe 12 --n 2000000 --dim 512 --d 160 --clusters 48 \
        --batch 1024 --kappa 100
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
binds it to the tag-sorted layout so every hop runs the gather-free
``graph_scan_beam_step`` kernel. Runs on the GPU; ``--device cpu`` runs
the kernels' plain versions at a small size. Prints the reference's
``QPS=... p50=... p99=... recall@10=...`` line.

``--stream`` drives the Section 3.2 lifecycle (paper Eq. 11-12) under live
traffic, as the reference's ``run_stream``: the model is fit on 70 % of
the collection with in-distribution queries, the traffic is OOD, and each
of ``--cycles`` cycles serves one batch (recall@10 against the exact
top-10 over the live rows), folds it into K_Q, inserts the next slice of
rows into the fixed-capacity store (and the IVF lists, or links them into
the graph, padded to the capacity, with ``graph.insert_ids``), refits the
model
(``streaming.refresh``) and swaps the re-encoded state in through
``ServingEngine.swap``. ``--refresh-source full`` re-encodes from the
rerank store instead of the Eq. 12 transition. Each cycle prints the
transition's condition number (the reference's refresh supervisor
re-encodes from the rerank store above 1e6). The reference's swap guard,
refresh supervisor, snapshots and fault drills are not ported yet.

    PYTHONPATH=src python -m repro_torch.launch.serve --stream \
        --mode gleanvec-int8 --n 5000 --dim 64 --d 16 --clusters 8 \
        --batch 64 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import gleanvec as gv
from repro_torch.core import leanvec_sphering as lvs
from repro_torch.core import metrics
from repro_torch.core import search as msearch
from repro_torch.core import streaming
from repro_torch.core.scorer import MODES
from repro_torch.data import vectors
from repro_torch.device import resolve_device
from repro_torch.index import graph, ivf
from repro_torch.serve.engine import ServingEngine


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
                 list_slack: int = 0, device=None) -> msearch.ServingState:
    """A fixed-capacity streaming store over ``x[:n0]``
    (``streaming.build_streaming_artifacts``) behind the flat scan, or
    behind an aligned IVF (sorted modes) widened by ``list_slack`` free
    slots per list, optionally with the reduced-space probe."""
    art = streaming.build_streaming_artifacts(
        mode, x[:n0], model, capacity=capacity, sort_block=STREAM_SORT_BLOCK,
        slack_blocks=slack_blocks, device=device)
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


def live_recall(engine: ServingEngine, queries: np.ndarray, served,
                k: int = 10) -> float:
    """recall@k of ``served`` ids against the exact top-k over the engine's
    live rows (on the store's device)."""
    art = engine.state.artifacts
    live_idx = torch.nonzero(streaming.live_mask(art)).squeeze(1)
    dev = art.x_full.device
    rows = art.x_full[live_idx]
    if dev.type == "cuda":
        gt = vectors.exact_topk(queries, rows, k, device=dev)
    else:
        gt = vectors.exact_topk(queries, rows.numpy(), k)
    gt = live_idx.cpu().numpy()[gt]
    return metrics.recall_at_k(served, gt)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stream_cycle(engine: ServingEngine, stream, rows, remove=None,
                 source: str = "stored"):
    """One stream cycle after serving: insert ``rows`` (full-D, on the
    store's device) into free slots and the IVF lists (or link them into
    the graph with ``graph.insert_ids``), tombstone the
    external ids ``remove`` (their moments downdated), swap; then refit,
    re-encode from ``source`` and swap again. Returns ``(stream, report)``
    with host-clock ms of the two halves and the transition's condition
    number."""
    dev = engine.device
    t0 = time.perf_counter()
    st = engine.state
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
        stream = streaming.remove(stream, arts.x_full[remove.long()])
        arts = streaming.remove_rows(arts, remove)
        if isinstance(index, ivf.IVFIndex):
            index = ivf.remove_ids(index, remove)
    engine.swap(st._replace(artifacts=arts, index=index))
    _sync(dev)
    t1 = time.perf_counter()
    stream = streaming.refresh(stream)
    engine.swap(streaming.refresh_state(engine.state, stream, source=source))
    _sync(dev)
    t2 = time.perf_counter()
    return stream, {"insert_ms": (t1 - t0) * 1e3,
                    "refresh_ms": (t2 - t1) * 1e3,
                    "condition": streaming.transition_condition(stream)}


def run_stream(args, dev):
    """The ``--stream`` lifecycle (see the module docstring)."""
    n0 = int(args.n * 0.7)
    step = (args.n - n0) // args.cycles
    ds = vectors.make_dataset("serve-stream", n=args.n, d=args.dim,
                              n_queries=max(512, args.batch * args.cycles),
                              ood=True, seed=0)
    x = torch.as_tensor(ds.database, device=dev)
    qt = ds.queries_test
    rng = np.random.default_rng(0)
    # the model serving at t=0 is fit on ID (database-like) queries; the
    # traffic is OOD -- the drift the refreshes adapt to
    q_init = ds.database[rng.integers(0, n0, 1024)] \
        + 0.1 * rng.standard_normal((1024, args.dim)).astype(np.float32)
    model = fit_model(args.mode, q_init, x[:n0], args.d, args.clusters, dev)
    slack = 1
    if args.mode.endswith("-sorted"):
        slack = stream_slack_blocks(model, x[n0:])
    state = build_stream(args.mode, x, n0, args.n, model,
                         index="flat" if args.index == "graph" else args.index,
                         nprobe=args.nprobe, reduced_probe=args.reduced_probe,
                         slack_blocks=slack,
                         list_slack=4 * max(1, (args.n - n0)
                                            // args.clusters),
                         device=dev)
    if args.index == "graph":
        state = state._replace(index=build_graph(
            args, x[:n0], state.artifacts.scorer, dev, capacity=args.n))
    engine = ServingEngine(state, k=10, kappa=args.kappa,
                           batch_size=args.batch, dim=args.dim)
    stream = streaming.init_from_artifacts(state.artifacts, q_init,
                                           refresh_every=step)
    print(f"stream mode={args.mode} index={args.index} n0={n0} "
          f"capacity={args.n} D={args.dim} d={args.d} cycles={args.cycles} "
          f"inserts/cycle={step} sorted slack_blocks={slack} "
          f"(block {STREAM_SORT_BLOCK}) device={dev}")
    for cycle in range(args.cycles):
        obs = qt[(cycle * args.batch) % len(qt):][:args.batch]
        live = int(streaming.live_mask(engine.state.artifacts).sum())
        served = engine.submit(obs)
        rec = live_recall(engine, obs, served)
        stream = streaming.observe_queries(stream, obs)
        rows = x[live:min(live + step, args.n)]
        rep = {"insert_ms": 0.0, "refresh_ms": 0.0,
               "condition": float("nan")}
        if rows.shape[0]:
            stream, rep = stream_cycle(engine, stream, rows,
                                       source=args.refresh_source)
        print(f"  cycle {cycle}: served {served.shape[0]} queries "
              f"recall@10={rec:.3f} live_rows="
              f"{int(streaming.live_mask(engine.state.artifacts).sum())} "
              f"version={engine.version} insert={rep['insert_ms']:.1f}ms "
              f"refresh={rep['refresh_ms']:.1f}ms "
              f"source={args.refresh_source} cond={rep['condition']:.3g}")
    s = engine.stats
    print(f"QPS={s.qps:.0f} p50={s.percentile_ms(50):.1f}ms "
          f"p99={s.percentile_ms(99):.1f}ms swaps={engine.n_swaps}")


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
                         "layout (graph.with_fused_scan) so every hop runs "
                         "the gather-free graph_scan_beam_step kernel")
    ap.add_argument("--stream", action="store_true",
                    help="drive the Section 3.2 observe -> insert -> "
                         "refresh -> swap lifecycle under live traffic")
    ap.add_argument("--cycles", type=int, default=3,
                    help="streaming refresh cycles (--stream)")
    ap.add_argument("--refresh-source", default="stored",
                    choices=["stored", "full"],
                    help="--stream: refresh through Eq. 12 over the stored "
                         "vectors or re-encode from the rerank store")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.index == "graph" and args.fused_graph \
            and not args.mode.endswith("-sorted"):
        raise SystemExit("--fused-graph needs a sorted scorer mode "
                         "(gleanvec-sorted / gleanvec-int8-sorted)")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.stream:
        if args.mode == "full":
            raise SystemExit("--stream needs a DR mode")
        if args.index == "ivf" and not args.aligned:
            raise SystemExit("--stream --index ivf needs --aligned")
        run_stream(args, dev)
        return
    ds = vectors.make_dataset("serve", n=args.n, d=args.dim,
                              n_queries=512, ood=True, seed=0,
                              gt_device=dev if dev.type == "cuda" else None)
    x = torch.as_tensor(ds.database, device=dev)
    model = fit_model(args.mode, ds.queries_learn, x, args.d, args.clusters,
                      dev)
    artifacts = msearch.build_artifacts(args.mode, x, model, device=dev)
    index = build_index(args, x, artifacts.scorer, model, dev)
    kappa = 10 if args.mode == "full" else args.kappa
    engine = ServingEngine(msearch.make_state(artifacts, index=index), k=10,
                           kappa=kappa, batch_size=args.batch, dim=args.dim)
    ids = engine.submit(ds.queries_test)
    rec = metrics.recall_at_k(ids, ds.gt[:, :10])
    s = engine.stats
    print(f"mode={args.mode} index={args.index} single n={args.n} "
          f"D={args.dim} d={args.d} reduced_probe={args.reduced_probe} "
          f"device={dev}")
    print(f"QPS={s.qps:.0f} p50={s.percentile_ms(50):.1f}ms "
          f"p99={s.percentile_ms(99):.1f}ms recall@10={rec:.3f}")


if __name__ == "__main__":
    main()
