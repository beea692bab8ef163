"""Serving CLI: the search service (Algorithm 1) over a synthetic
collection, with a selectable scorer mode and index -- the single-device
flat and IVF paths of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode gleanvec \
        --n 2000000 --dim 512 --d 160 --clusters 48 --batch 1024 --kappa 100
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --mode gleanvec-int8-sorted --index ivf --aligned --reduced-probe \
        --nprobe 12 --n 2000000 --dim 512 --d 160 --clusters 48 \
        --batch 1024 --kappa 100

``--index ivf`` serves an IVF index: its own k-means over ``--lists``
lists, or with ``--aligned`` (sorted modes only) the GleanVec clustering
itself, whose fine step is the gather-free ``ivf_scan_topk`` kernel;
``--reduced-probe`` scores the coarse centers in the scorer's reduced
space. Runs on the GPU; ``--device cpu`` runs the kernels' plain versions
at a small size. Prints the reference's ``QPS=... p50=... p99=...
recall@10=...`` line.
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
from repro_torch.index import ivf
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


def build_index(args, x, scorer, model, device):
    """The --index axis: an Index-protocol object (None = the flat scan)."""
    if args.index == "flat":
        return None
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="gleanvec", choices=list(MODES))
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--clusters", type=int, default=48)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--kappa", type=int, default=50)
    ap.add_argument("--index", default="flat", choices=["flat", "ivf"])
    ap.add_argument("--lists", type=int, default=64,
                    help="IVF lists of the k-means index (not --aligned)")
    ap.add_argument("--nprobe", type=int, default=12)
    ap.add_argument("--reduced-probe", action="store_true",
                    help="IVF: score the coarse centers in the scorer's "
                         "reduced space")
    ap.add_argument("--aligned", action="store_true",
                    help="IVF over the GleanVec clustering (sorted modes): "
                         "the gather-free range-scan fine step")
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
