"""End-to-end serving on the PyTorch port (the paper's deployment
scenario): build a GleanVec index over a vector collection and serve
batched queries through ``ServingEngine``, reporting QPS, latency
percentiles and recall -- then hot-swap a refreshed state. The port's
counterpart of ``examples/serve_vector_search.py``; on the GPU by default
(``--device cpu`` runs the kernels' plain versions).

    PYTHONPATH=src python examples/torch_serve_vector_search.py [--n 50000]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import gleanvec as gv, metrics
from repro_torch.core import search as msearch
from repro_torch.data import vectors
from repro_torch.device import resolve_device
from repro_torch.serve.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--clusters", type=int, default=48)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--kappa", type=int, default=50)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="the GPU by default; cpu for the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"== building collection n={args.n} D={args.dim} on {dev} ==")
    ds = vectors.make_dataset("serve-OOD", n=args.n, d=args.dim,
                              n_queries=args.queries, ood=True, seed=0,
                              gt_device=dev)
    X = torch.as_tensor(ds.database, device=dev)
    gmodel = gv.fit(ds.queries_learn, X, c=args.clusters, d=args.d,
                    device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    artifacts = msearch.build_artifacts("gleanvec", X, gmodel, device=dev)
    print(f"encoded: {args.dim * 4}B -> {args.d * 4 + 1}B per vector "
          f"({args.dim * 4 / (args.d * 4 + 1):.1f}x bandwidth saving)")

    print("== serving ==")
    engine = ServingEngine(msearch.make_state(artifacts), k=10,
                           kappa=args.kappa, batch_size=args.batch,
                           dim=args.dim)
    ids = engine.submit(ds.queries_test)
    rec = metrics.recall_at_k(ids, ds.gt[:, :10])
    s = engine.stats
    print(f"queries={s.n_queries} batches={s.n_batches}")
    print(f"QPS={s.qps:.0f}  p50={s.percentile_ms(50):.1f}ms  "
          f"p99={s.percentile_ms(99):.1f}ms  recall@10={rec:.3f}")

    # the artifacts are an argument of the step, so a state of the same
    # structure (here: a refit on the served query traffic) swaps in
    # without touching the engine's buffers
    refit = gv.fit(ds.queries_test, X, c=args.clusters, d=args.d,
                   device=dev,
                   generator=torch.Generator(device=dev).manual_seed(1))
    engine.swap(engine.state._replace(
        artifacts=msearch.build_artifacts("gleanvec", X, refit, device=dev)))
    engine.submit(ds.queries_test[: args.batch])
    print(f"hot-swapped refit model: version={engine.version} "
          f"swap_p50={np.median(engine.stats.swap_ms):.2f}ms "
          f"batch shapes={engine.n_compiles} (still the warm-up's)")


if __name__ == "__main__":
    main()
