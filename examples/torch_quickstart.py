"""Quickstart on the PyTorch port: learn LeanVec-Sphering + GleanVec on
synthetic OOD data and run the multi-step search (paper Algorithms 1-5)
through the port's public API, on the GPU (``--device cpu`` runs the
kernels' plain versions). The port's counterpart of
``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core import gleanvec as gv, leanvec_sphering as lvs, metrics
from repro_torch.data import vectors
from repro_torch.device import resolve_device
from repro_torch.index import bruteforce


def rerank(cand, store, q, k: int = 10):
    """Algorithm 1 line 3: the top k of the candidates ``cand (m, kappa)``
    by their full-precision scores against ``q`` (rows of ``store``)."""
    vecs = store[cand.long()]
    top = torch.topk(torch.einsum("mkd,md->mk", vecs, q), k, dim=1).indices
    return torch.gather(cand, 1, top)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="the GPU by default; cpu for the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== GleanVec quickstart ==")
    ds = vectors.make_dataset("demo-OOD", n=args.n, d=args.dim,
                              n_queries=args.queries, ood=True, seed=0,
                              gt_device=dev)
    X = torch.as_tensor(ds.database, device=dev)
    Q = torch.as_tensor(ds.queries_learn, device=dev)
    QT = torch.as_tensor(ds.queries_test, device=dev)
    gt = ds.gt[:, :10]
    d = args.d
    print(f"database {tuple(X.shape)}, queries {tuple(QT.shape)}, "
          f"target d={d} on {dev}")

    # --- linear: LeanVec-Sphering (Algorithm 2) ---------------------------
    model = lvs.fit(Q, X, d, device=dev)
    _, cand = bruteforce.search(QT @ model.a.T, X @ model.b.T, 50,
                                device=dev)
    ids = rerank(cand, X, QT)
    print(f"LeanVec-Sphering  recall@10 = "
          f"{metrics.recall_at_k(ids.cpu(), gt):.3f} "
          f"(bandwidth saved: {X.shape[1] / d:.1f}x)")

    # --- nonlinear: GleanVec (Algorithm 5) --------------------------------
    gmodel = gv.fit(Q, X, c=16, d=d, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    tags, xg_low = gv.encode_database(gmodel, X)
    q_views = gv.project_queries_eager(gmodel, QT)      # Algorithm 4
    _, cand = bruteforce.search_gleanvec(q_views, tags, xg_low, 50,
                                         device=dev)
    ids = rerank(cand, X, QT)
    print(f"GleanVec (C=16)   recall@10 = "
          f"{metrics.recall_at_k(ids.cpu(), gt):.3f} "
          f"(+1 tag byte/vector)")

    # --- flexible d at runtime (Section 3.1) ------------------------------
    full = lvs.full_rotation_model(Q, X, device=dev)
    x_store = X @ full.b.T
    q_rot = QT @ full.a.T
    for d_run in (32, 64, 128):
        _, cand = bruteforce.search(q_rot[:, :d_run].contiguous(),
                                    x_store[:, :d_run].contiguous(), 50,
                                    device=dev)
        ids = rerank(cand, x_store, q_rot)          # rerank from SAME store
        print(f"flexible-d d={d_run:4d} recall@10 = "
              f"{metrics.recall_at_k(ids.cpu(), gt):.3f} "
              f"(same stored vectors)")


if __name__ == "__main__":
    main()
