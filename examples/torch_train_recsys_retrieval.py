"""Train a small MIND recommender for a few hundred steps on the PyTorch
port, then build a GleanVec retrieval index over the LEARNED item
embeddings and serve candidate retrieval -- the paper's technique inside a
training system. The port's counterpart of
``examples/train_recsys_retrieval.py``; on the GPU by default (``--device
cpu`` runs the kernels' plain versions).

    PYTHONPATH=src python examples/torch_train_recsys_retrieval.py \\
        [--steps 200]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core import gleanvec as gv, metrics
from repro_torch.device import resolve_device
from repro_torch.models import recsys
from repro_torch.serve import retrieval
from repro_torch.train import AdamWConfig, data, make_train_step
from repro_torch.train.optimizer import adamw_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--items", type=int, default=20_000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="the GPU by default; cpu for the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = recsys.MINDConfig(name="mind-demo", n_items=args.items,
                            seq_len=16, embed_dim=32, n_interests=4)
    params = recsys.mind.init(torch.Generator(device=dev).manual_seed(0),
                              cfg, device=dev)
    opt = adamw_init(params)
    step = make_train_step(lambda p, b: recsys.mind.ctr_loss(p, b, cfg),
                           AdamWConfig(lr=3e-3), warmup=20,
                           total_steps=args.steps)

    print(f"== training MIND ({args.items} items) for {args.steps} steps "
          f"on {dev} ==")
    t0 = time.time()
    for i in range(args.steps):
        batch = data.mind_batch(0, i, args.batch, cfg.seq_len, cfg.n_items,
                                device=dev)
        params, opt, m = step(params, opt, batch)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(m['loss']):.4f} "
                  f"({(time.time() - t0):.0f}s)")

    # --- retrieval over learned item embeddings (the paper's MIPS) --------
    with torch.no_grad():
        item_emb = params["item_emb"].detach()
        batch = data.mind_batch(0, 999, 128, cfg.seq_len, cfg.n_items,
                                device=dev)
        users = recsys.mind.user_embedding(params, batch, cfg)

        idx_full = retrieval.build_retrieval_index(item_emb, "full",
                                                   device=dev)
        ids_full = retrieval.retrieve(idx_full, users, k=10)

        gmodel = gv.fit(users, item_emb, c=16, d=8, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
        idx_gv = retrieval.build_retrieval_index(item_emb, "gleanvec",
                                                 gmodel, device=dev)
        ids_gv = retrieval.retrieve(idx_gv, users, k=10, kappa=100)

    agree = metrics.recall_at_k(ids_gv.cpu(), ids_full.cpu())
    print(f"== retrieval ==\nGleanVec (32->8 dims) agreement with "
          f"full-precision retrieval: {agree:.3f}")
    print("bandwidth per candidate: "
          f"{32 * 4}B -> {8 * 4 + 1}B ({32 * 4 / (8 * 4 + 1):.1f}x)")


if __name__ == "__main__":
    main()
