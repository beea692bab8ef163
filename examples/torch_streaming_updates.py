"""Streaming vector search on the PyTorch port (paper Section 3.2):
inserts with moment tracking, periodic refresh, and Eq. 12 reprojection of
the stored vectors. The port's counterpart of
``examples/streaming_updates.py``; on the GPU by default (``--device
cpu`` runs the kernels' plain versions).

    PYTHONPATH=src python examples/torch_streaming_updates.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core import linalg, metrics, streaming
from repro_torch.data import vectors
from repro_torch.device import resolve_device
from repro_torch.index import bruteforce


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=12_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--initial", type=int, default=8000)
    ap.add_argument("--every", type=int, default=1000,
                    help="rows a chunk, and the refresh period")
    ap.add_argument("--device", default=None,
                    help="the GPU by default; cpu for the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = vectors.make_dataset("stream-OOD", n=args.n, d=args.dim,
                              n_queries=128, ood=True, seed=3,
                              gt_device=dev)
    X = torch.as_tensor(ds.database, device=dev)
    Q = torch.as_tensor(ds.queries_learn, device=dev)
    n0 = args.initial

    st = streaming.init(linalg.second_moment(Q),
                        linalg.second_moment(X[:n0]), d=args.dim,
                        refresh_every=args.every)
    x_store = X[:n0] @ st.model.b.T
    print(f"initial store: {tuple(x_store.shape)} on {dev}")

    # stream in the remaining vectors; refresh + reproject at boundaries
    inserted = n0
    for start in range(n0, args.n, args.every):
        stop = min(start + args.every, args.n)
        for i in range(start, stop):
            st = streaming.insert(st, X[i])
        new = X[start:stop] @ st.model.b.T
        x_store = torch.cat([x_store, new], dim=0)
        inserted = stop
        if streaming.needs_refresh(st):
            st = streaming.refresh(st)
            x_store = streaming.reproject(st, x_store)   # Eq. 12
            print(f"  refreshed at n={inserted}; store reprojected")

    # search the final store (reduced d=64 prefix via Section 3.1)
    qt = torch.as_tensor(ds.queries_test, device=dev)
    q_low = (qt @ st.model.a[:64].T).contiguous()
    _, cand = bruteforce.search(q_low, x_store[:, :64].contiguous(), 50,
                                device=dev)
    vecs = X[cand.long()]
    top = torch.topk(torch.einsum("mkd,md->mk", vecs, qt), 10, dim=1).indices
    ids = torch.gather(cand, 1, top)
    rec = metrics.recall_at_k(ids.cpu(), ds.gt[:, :10])
    print(f"final recall@10 after streaming build: {rec:.3f}")


if __name__ == "__main__":
    main()
