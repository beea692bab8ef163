"""Training driver with fault tolerance (port of ``repro/launch/train.py``):

  * periodic atomic checkpoints (params + optimizer state + step) through
    ``train/checkpoint.py``;
  * crash recovery: ``--resume`` restores the latest checkpoint and replays
    the deterministic data stream from the restored step;
  * failure injection for drills: ``REPRO_FAIL_AT_STEP=<n>`` exits 42 at
    step n;
  * straggler watchdog: a step slower than the median of the steps so far
    times ``--straggler-factor`` (after 5 steps) is logged and counted.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-3-4b \\
        --shape train_4k --smoke --steps 20 --device cpu \\
        [--ckpt-dir /tmp/ck [--ckpt-every 2] [--resume]]

Runs on the GPU; ``--device cpu`` runs the CPU path (the smoke configs).
Float leaves start N(0, 0.02^2) and integer leaves zero, each from a
generator seeded by ``zlib.crc32`` of the leaf's path -- never Python's
``hash()``, which is salted per process: the reference seeds its generic
recsys batches and its leaves with it, so a run and its ``--resume`` draw
other numbers (ROADMAP C6). Batches: ``data.lm_batch`` for the LMs,
``criteo_batch`` / ``bst_batch`` / ``mind_batch`` for the recommenders,
and for ``gcn-cora`` valid graphs drawn from the seed (``data.gnn_graph``,
``gnn_csr``; drawn once a run) with each step's ``gnn_minibatch`` or
``molecule_batch`` -- the reference fills its GNN batches with generic
random numbers, ids past the graph among them (ROADMAP C7).
On the CPU a restart is bit for bit the uninterrupted run; on the card
within rounding (the embedding's and the GCN's backward add with
atomics).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \\
        --shape minibatch_lg --smoke --steps 4 --device cpu
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
import zlib

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch.steps import build_bundle
from repro_torch.train import checkpoint
from repro_torch.train import data as data_mod

FAIL_EXIT = 42


def make_graph(module, bundle, seed: int = 0):
    """The graph a full-graph or minibatch GNN bundle trains on, on its
    device (a function of ``seed`` alone; the minibatch's in CSR, with its
    nodes' labels); None for every other bundle."""
    shapes, cfg = bundle.args[2], bundle.config
    if module.FAMILY != "gnn" or shapes["feats"].ndim != 2:
        return None
    n, f = shapes["feats"].shape
    e = shapes["edges"].shape[1] if "edges" in shapes else \
        shapes["indices"].shape[0]
    graph = data_mod.gnn_graph(seed, n, e, f, cfg.n_classes,
                               device=bundle.device)
    if "edges" in shapes:
        return graph
    return {"feats": graph["feats"], "labels": graph["labels"],
            **data_mod.gnn_csr(graph["edges"], n)}


def _gnn_batch(bundle, step: int, seed: int, graph):
    shapes, cfg = bundle.args[2], bundle.config
    if "edges" in shapes and shapes["edges"].ndim == 3:     # molecules
        g, n, f = shapes["feats"].shape
        return data_mod.molecule_batch(seed, step, g, n,
                                       shapes["edges"].shape[1], f,
                                       cfg.n_classes, device=bundle.device)
    if "edges" in shapes:                                   # full graph
        return graph
    return data_mod.gnn_minibatch(graph, seed, step,
                                  shapes["seeds"].shape[0], cfg.fanouts)


def make_batch(module, bundle, step: int, seed: int = 0, graph=None):
    """The deterministic batch of ``step`` at the bundle's shapes, on its
    device. A GNN's graph is ``graph`` (``make_graph``'s) or drawn anew.
    The rows are in the one-process step's order; a bundle built for a
    mesh of several data ranks takes an LM batch laid out by
    ``trainstep.rank_major(batch, accumulation, data ranks)`` before each
    rank cuts its block, so that its microbatch i is this batch's."""
    shapes, cfg, dev = bundle.args[2], bundle.config, bundle.device
    if module.FAMILY == "gnn":
        if graph is None:
            graph = make_graph(module, bundle, seed)
        return _gnn_batch(bundle, step, seed, graph)
    if module.FAMILY == "lm":
        b, s = shapes["tokens"].shape
        return data_mod.lm_batch(seed, step, b, s, cfg.vocab, device=dev)
    return recsys_batch(module.MODEL, cfg,
                        next(iter(shapes.values())).shape[0], seed, step,
                        dev)


def recsys_batch(model: str, cfg, b: int, seed: int, step: int, device):
    """A recommender's batch of ``b`` rows (its training form; the serve
    steps read the same) at ``step``, drawn from ``seed`` on ``device``."""
    if model == "mind":
        return data_mod.mind_batch(seed, step, b, cfg.seq_len, cfg.n_items,
                                   device=device)
    if model == "bst":
        return data_mod.bst_batch(seed, step, b, cfg.seq_len, cfg.n_items,
                                  device=device)
    if model == "dlrm":
        return data_mod.criteo_batch(seed, step, b, cfg.n_dense,
                                     cfg.vocab_sizes, device=device)
    batch = data_mod.criteo_batch(seed, step, b, 0,
                                  (cfg.vocab_per_field,) * cfg.n_sparse,
                                  device=device)
    return {"sparse": batch["sparse"], "label": batch["label"]}


def materialize(abstract, device):
    """Real leaves for an abstract tree: float leaves N(0, 0.02^2) from a
    generator seeded by the crc32 of the leaf's path, integer leaves 0."""
    paths, leaves, treedef = tree.flatten_with_paths(abstract)
    out = []
    for path, a in zip(paths, leaves):
        if not a.dtype.is_floating_point:
            out.append(torch.zeros(a.shape, dtype=a.dtype, device=device))
            continue
        gen = torch.Generator(device=device).manual_seed(
            zlib.crc32(path.encode()))
        out.append((torch.randn(a.shape, generator=gen, device=device)
                    * 0.02).to(a.dtype))
    return treedef.unflatten(out)


def _place(restored, like):
    """Restored leaves (numpy, or CPU tensors for bf16) on ``like``'s
    devices and dtypes."""
    leaves, treedef = tree.flatten(like)
    return treedef.unflatten([
        torch.as_tensor(np.asarray(r) if not isinstance(r, torch.Tensor)
                        else r).to(device=t.device, dtype=t.dtype)
        for r, t in zip(tree.leaves(restored), leaves)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (runs on the CPU)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--device", default=None,
                    help="cpu runs the CPU path; default: the GPU")
    args = ap.parse_args(argv)

    module = registry.get(args.arch)
    bundle = build_bundle(args.arch, args.shape, smoke=args.smoke,
                          device=args.device)
    if bundle.opt_init is None:
        ap.error(f"{args.arch}:{args.shape} is a "
                 f"{module.SHAPES[args.shape]['kind']} step; this command "
                 "trains only")
    dev = bundle.device
    fail_at = int(os.environ.get("REPRO_FAIL_AT_STEP", -1))

    params = materialize(bundle.args[0], dev)
    opt = bundle.opt_init(params)
    start_step = 0
    if args.resume and args.ckpt_dir and checkpoint.latest_step(
            args.ckpt_dir) is not None:
        state = {"params": params, "opt": opt}
        restored, start_step, _ = checkpoint.restore(args.ckpt_dir, state)
        state = _place(restored, state)
        params, opt = state["params"], state["opt"]
        print(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    graph = make_graph(module, bundle, args.seed)
    durations = []
    stragglers = 0
    metrics = None
    for i in range(start_step, args.steps):
        if i == fail_at:
            print(f"[drill] injected failure at step {i}; restart with "
                  "--resume", flush=True)
            return FAIL_EXIT
        batch = make_batch(module, bundle, i, args.seed, graph)
        t0 = time.perf_counter()
        params, opt, metrics = bundle.fn(params, opt, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if len(durations) >= 5:
            deadline = statistics.median(durations) * args.straggler_factor
            if dt > deadline:
                stragglers += 1
                print(f"[straggler] step {i} took {dt:.2f}s (deadline "
                      f"{deadline:.2f}s) -- flagged")
        durations.append(dt)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s",
                  flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, i + 1,
                            {"params": params, "opt": opt},
                            meta={"arch": args.arch, "shape": args.shape})
            print(f"[ckpt] step {i + 1} -> {args.ckpt_dir}")
    if metrics is not None:
        print(f"final loss {float(metrics['loss'])!r} grad_norm "
              f"{float(metrics['grad_norm'])!r}")
    print(f"done: {args.steps - start_step} steps, {stragglers} straggler "
          "events, median step "
          f"{statistics.median(durations) if durations else 0.0:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
