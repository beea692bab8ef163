"""Deterministic synthetic batches (port of ``repro/train/data.py``).

Every batch is a pure function of (seed, step): a ``torch.Generator`` on
the batch's device seeded from (seed, salt, step), with the reference's
salts, shapes, value ranges and label rate, so a restart replays the exact
stream with no pipeline state to checkpoint. The numbers are not
``jax.random``'s.

The GNN's graphs are drawn here too (the reference's ``launch/train.py``
fills its GNN batches with generic random numbers: ids past the graph, a
CSR ``indptr`` that is not monotone, labels 0 and 1 only; ROADMAP C7). A
graph is a function of the seed alone (salt 6), so a training loop draws
it once and reuses it across steps; a step's seeds (salt 5, the
reference's) and sampling draws (salt 7) and a molecule batch (salt 8)
are functions of (seed, step).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.device import resolve_device

__all__ = ["lm_batch", "criteo_batch", "bst_batch", "mind_batch",
           "graph_minibatch_seeds", "gnn_graph", "gnn_csr",
           "gnn_minibatch", "molecule_batch", "MASK_RATE"]

# The share of a full graph's nodes in the loss: near Cora's (140 of 2,708
# nodes, 5.2 %) and ogbn-products' (196,615 of 2,449,029, 8.0 %) public
# training splits.
MASK_RATE = 0.1


def _gen(seed: int, step: int, salt: int, dev) -> torch.Generator:
    """One generator per (seed, salt, step); distinct triples get
    distinct 63-bit seeds (each field in its own bits)."""
    key = ((int(seed) & 0xFFFFFFFF) << 31) ^ ((int(salt) & 0xFF) << 23) \
        ^ (int(step) & 0x7FFFFF)
    return torch.Generator(device=dev).manual_seed(key & ((1 << 63) - 1))


def _labels(gen, batch: int, dev) -> torch.Tensor:
    return (torch.rand(batch, generator=gen, device=dev) < 0.3).to(
        torch.int32)


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             device=None) -> Dict[str, torch.Tensor]:
    """``tokens`` and ``labels`` (B, seq) int32: one draw of seq + 1 ids
    below ``vocab`` a row, the labels shifted by one."""
    dev = resolve_device(device)
    g = _gen(seed, step, 1, dev)
    tokens = torch.randint(0, vocab, (batch, seq + 1), generator=g,
                           device=dev, dtype=torch.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def criteo_batch(seed: int, step: int, batch: int, n_dense: int,
                 vocab_sizes, device=None) -> Dict[str, torch.Tensor]:
    """``dense (B, n_dense)`` normal f32, ``sparse (B, F)`` field-local
    ids below each table's size, ``label (B,)`` int32 at rate 0.3."""
    dev = resolve_device(device)
    g = _gen(seed, step, 2, dev)
    dense = torch.randn((batch, n_dense), generator=g, device=dev)
    maxes = torch.as_tensor(list(vocab_sizes), dtype=torch.int64, device=dev)
    sparse = (torch.randint(0, 1 << 30, (batch, len(vocab_sizes)),
                            generator=g, device=dev) % maxes[None, :])
    return {"dense": dense, "sparse": sparse.to(torch.int32),
            "label": _labels(g, batch, dev)}


def bst_batch(seed: int, step: int, batch: int, seq_len: int, n_items: int,
              device=None) -> Dict[str, torch.Tensor]:
    """``seq (B, S)`` and ``target (B,)`` item ids, ``label (B,)``."""
    dev = resolve_device(device)
    g = _gen(seed, step, 3, dev)
    seq = torch.randint(0, n_items, (batch, seq_len), generator=g,
                        device=dev, dtype=torch.int32)
    target = torch.randint(0, n_items, (batch,), generator=g, device=dev,
                           dtype=torch.int32)
    return {"seq": seq, "target": target, "label": _labels(g, batch, dev)}


def mind_batch(seed: int, step: int, batch: int, seq_len: int, n_items: int,
               device=None) -> Dict[str, torch.Tensor]:
    """``seq (B, S)`` and ``target (B,)`` item ids."""
    dev = resolve_device(device)
    g = _gen(seed, step, 4, dev)
    return {"seq": torch.randint(0, n_items, (batch, seq_len), generator=g,
                                 device=dev, dtype=torch.int32),
            "target": torch.randint(0, n_items, (batch,), generator=g,
                                    device=dev, dtype=torch.int32)}


def graph_minibatch_seeds(seed: int, step: int, batch: int, n_nodes: int,
                          device=None) -> torch.Tensor:
    """``batch`` seed nodes (int32, below ``n_nodes``) of ``step``."""
    dev = resolve_device(device)
    return torch.randint(0, n_nodes, (batch,), generator=_gen(
        seed, step, 5, dev), device=dev, dtype=torch.int32)


def _undirected(gen, n_nodes: int, n_edges: int, shape, dev):
    """(src, dst) int32 of ``shape + (n_edges,)``: ``n_edges / 2`` pairs
    ``a != b`` below ``n_nodes``, each emitted as a -> b and b -> a."""
    if n_edges % 2 or n_nodes < 2:
        raise ValueError(f"{n_edges} edges over {n_nodes} nodes: an "
                         "undirected graph needs an even count and 2 nodes")
    half = shape + (n_edges // 2,)
    a = torch.randint(0, n_nodes, half, generator=gen, device=dev,
                      dtype=torch.int32)
    b = (a + 1 + torch.randint(0, n_nodes - 1, half, generator=gen,
                               device=dev, dtype=torch.int32)) % n_nodes
    return torch.cat([a, b], -1), torch.cat([b, a], -1)


def gnn_graph(seed: int, n_nodes: int, n_edges: int, d_feat: int,
              n_classes: int, device=None) -> Dict[str, torch.Tensor]:
    """A full graph's batch, a function of ``seed`` alone: ``feats (n, F)``
    N(0, 1) f32, ``edges (2, E)`` int32 (``E / 2`` undirected pairs without
    self-loops, both directions), ``labels (n,)`` int32 below
    ``n_classes`` and ``mask (n,)`` f32 0/1 at rate ``MASK_RATE``."""
    dev = resolve_device(device)
    g = _gen(seed, 0, 6, dev)
    src, dst = _undirected(g, n_nodes, n_edges, (), dev)
    feats = torch.randn((n_nodes, d_feat), generator=g, device=dev)
    labels = torch.randint(0, n_classes, (n_nodes,), generator=g,
                           device=dev, dtype=torch.int32)
    mask = (torch.rand(n_nodes, generator=g, device=dev) < MASK_RATE).to(
        torch.float32)
    return {"feats": feats, "edges": torch.stack([src, dst]),
            "labels": labels, "mask": mask}


def gnn_csr(edges: torch.Tensor, n_nodes: int) -> Dict[str, torch.Tensor]:
    """``edges (2, E)`` sorted by source into CSR: ``indptr (n + 1,)`` and
    ``indices (E,)`` int32 (a node's neighbours in edge-list order)."""
    src, order = torch.sort(edges[0], stable=True)
    indptr = torch.searchsorted(
        src, torch.arange(n_nodes + 1, dtype=torch.int32,
                          device=edges.device), out_int32=True)
    return {"indptr": indptr, "indices": edges[1].index_select(0, order)}


def gnn_minibatch(graph: Dict[str, torch.Tensor], seed: int, step: int,
                  batch: int, fanouts) -> Dict[str, torch.Tensor]:
    """The minibatch of ``step`` on ``graph`` (``feats``, ``indptr``,
    ``indices`` and the nodes' ``labels``): ``graph_minibatch_seeds``, their
    labels, and the sampling draws ``rand1 (B, f1)`` and ``rand2 (B, f1,
    f2)`` int32 in [0, 2^30), on the graph's device."""
    dev = graph["feats"].device
    n = graph["indptr"].shape[0] - 1
    f1, f2 = fanouts
    seeds = graph_minibatch_seeds(seed, step, batch, n, device=dev)
    g = _gen(seed, step, 7, dev)
    draws = torch.randint(0, 1 << 30, (batch, f1, 1 + f2), generator=g,
                          device=dev, dtype=torch.int32)
    return {"feats": graph["feats"], "indptr": graph["indptr"],
            "indices": graph["indices"], "seeds": seeds,
            "labels": graph["labels"].index_select(0, seeds),
            "rand1": draws[..., 0].contiguous(),
            "rand2": draws[..., 1:].contiguous()}


def molecule_batch(seed: int, step: int, batch: int, n_nodes: int,
                   n_edges: int, d_feat: int, n_classes: int,
                   device=None) -> Dict[str, torch.Tensor]:
    """``batch`` small graphs of ``step``: ``feats (G, N, F)`` N(0, 1),
    ``edges (G, E, 2)`` int32 graph-local ids (``E / 2`` undirected pairs
    without self-loops, both directions), ``labels (G,)`` int32 (0/1 at
    rate 0.3 for one class, else below ``n_classes``)."""
    dev = resolve_device(device)
    g = _gen(seed, step, 8, dev)
    src, dst = _undirected(g, n_nodes, n_edges, (batch,), dev)
    feats = torch.randn((batch, n_nodes, d_feat), generator=g, device=dev)
    labels = _labels(g, batch, dev) if n_classes == 1 else torch.randint(
        0, n_classes, (batch,), generator=g, device=dev, dtype=torch.int32)
    return {"feats": feats, "edges": torch.stack([src, dst], -1),
            "labels": labels}
