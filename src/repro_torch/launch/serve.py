"""Serving driver: the flat-index search service (Algorithm 1) over a
synthetic collection, with a selectable scorer mode -- the flat path of
``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode gleanvec \
        --n 2000000 --dim 512 --d 160 --clusters 48 --batch 1024 --kappa 100

Runs on the GPU; ``--device cpu`` runs the kernels' plain versions at a
small size. Prints the reference's ``QPS=... p50=... p99=... recall@10=...``
line.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import gleanvec as gv
from repro_torch.core import leanvec_sphering as lvs
from repro_torch.core import metrics
from repro_torch.core import search as msearch
from repro_torch.core.scorer import MODES
from repro_torch.data import vectors
from repro_torch.device import resolve_device
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="gleanvec", choices=list(MODES))
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--clusters", type=int, default=48)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--kappa", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ds = vectors.make_dataset("serve", n=args.n, d=args.dim,
                              n_queries=512, ood=True, seed=0,
                              gt_device=dev if dev.type == "cuda" else None)
    x = torch.as_tensor(ds.database, device=dev)
    model = fit_model(args.mode, ds.queries_learn, x, args.d, args.clusters,
                      dev)
    artifacts = msearch.build_artifacts(args.mode, x, model, device=dev)
    kappa = 10 if args.mode == "full" else args.kappa
    engine = ServingEngine(msearch.make_state(artifacts), k=10, kappa=kappa,
                           batch_size=args.batch, dim=args.dim)
    ids = engine.submit(ds.queries_test)
    rec = metrics.recall_at_k(ids, ds.gt[:, :10])
    s = engine.stats
    print(f"mode={args.mode} index=flat single n={args.n} D={args.dim} "
          f"d={args.d} device={dev}")
    print(f"QPS={s.qps:.0f} p50={s.percentile_ms(50):.1f}ms "
          f"p99={s.percentile_ms(99):.1f}ms recall@10={rec:.3f}")


if __name__ == "__main__":
    main()
