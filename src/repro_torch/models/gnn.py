"""GCN (Kipf & Welling) in the three execution regimes of ``gcn-cora``'s
shapes (port of ``repro/models/gnn.py``):

  * full graph (full_graph_sm / ogb_products): normalised message passing
    over a global edge list ``edges (2, E)`` int32 -- the gather of the
    source rows, the scale and the scatter-add into the destinations
    (``index_select``, ``index_add``) are the sparse product, as the
    reference's ``segment_sum`` pipeline is;
  * minibatch (minibatch_lg): GraphSAGE-style two-hop uniform neighbour
    sampling (fanouts 15, 10) from CSR on the device, then a dense batched
    aggregation;
  * batched small graphs (molecule): the reference's ``vmap`` over graphs
    as one disjoint union of the G graphs through the full-graph path,
    then a node mean-pool a graph.

Sampling is split from aggregation: the reference draws its offsets from
a ``jax.random`` key inside the step, which the port cannot reproduce. The
batch carries the uniform draws instead (``rand1 (B, f1)`` and ``rand2
(B, f1, f2)`` int32 in [0, 2^30): ``train/data.py`` draws them from (seed,
step)), and :func:`sample_neighbors` applies the reference's formula to
them, so the reference's own draws give its sampled ids exactly.

The reference's ``rules: MeshRules`` argument and its ``constrain`` calls
are left out: they are layout hints that change no value
(``models/sharding.constrain``). The edges' spec over the data axes (and
their padding to the data-parallel size) is the step bundle's
(``launch/steps._gnn_bundle``). No Pallas kernel is reached here, in the
reference either.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import layers

__all__ = ["GCNConfig", "init", "full_graph_logits", "full_graph_loss",
           "sample_neighbors", "minibatch_logits", "minibatch_loss",
           "batched_graphs_logits", "batched_graphs_loss"]


@dataclass(frozen=True)
class GCNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 16
    d_feat: int = 1433
    n_classes: int = 7
    aggregator: str = "mean"   # paper config: mean
    norm: str = "sym"          # symmetric D^-1/2 (A+I) D^-1/2
    fanouts: tuple = (15, 10)
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32


def init(cfg: GCNConfig, seed: int = 0,
         generator: Optional[torch.Generator] = None, device=None):
    """``{"w": [{"w", "b"}, ...]}``: one dense layer a GCN layer, d_feat ->
    d_hidden ... -> n_classes, at ``layers.dense_init``'s scale, drawn on
    ``device`` (the GPU by default) from ``generator`` or a generator
    seeded with ``seed``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(seed)
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) \
        + [cfg.n_classes]
    return {"w": [layers.dense_init(gen, dims[i], dims[i + 1],
                                    cfg.param_dtype, with_bias=True,
                                    device=dev)
                  for i in range(len(dims) - 1)]}


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for int32 ``ids`` of any shape."""
    return table.index_select(0, ids.reshape(-1)).reshape(
        ids.shape + table.shape[1:])


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row negative log-likelihood, in f32 (f64 logits stay f64)."""
    logp = F.log_softmax(logits.to(torch.promote_types(logits.dtype,
                                                       torch.float32)), -1)
    return -logp.gather(1, labels.long()[:, None])[:, 0]


# ---------------------------------------------------------------------------
# Full-graph path
# ---------------------------------------------------------------------------


def _edge_coefs(edges: torch.Tensor, n_nodes: int, norm: str):
    """(coef (E,), self_coef (n,)) of A-hat: ``rsqrt(deg[src]) *
    rsqrt(deg[dst])`` for ``norm="sym"``, ``1 / deg[dst]`` otherwise; the
    self-loop's ``1 / deg``, deg the in-degree + 1 (the self-loop). A
    function of the edges alone, so one forward computes it once for every
    layer."""
    src, dst = edges[0], edges[1]
    ones = torch.ones((1,), dtype=torch.float32,
                      device=dst.device).expand(dst.shape[0])
    deg = torch.zeros(n_nodes, dtype=torch.float32,
                      device=dst.device).index_add_(0, dst, ones) + 1.0
    if norm == "sym":
        r = torch.rsqrt(deg)
        coef = r.index_select(0, src) * r.index_select(0, dst)
    else:  # mean / rw normalisation
        coef = 1.0 / deg.index_select(0, dst)
    return coef, 1.0 / deg


def _gcn_propagate(h: torch.Tensor, edges: torch.Tensor, coef, self_coef):
    """One A-hat @ H product over ``edges (2, E)`` = (src, dst), the
    self-loops added analytically."""
    src, dst = edges[0], edges[1]
    msg = h.index_select(0, src).mul_(coef[:, None].to(h.dtype))
    agg = torch.zeros_like(h).index_add_(0, dst, msg)
    return agg + h * self_coef[:, None]


def full_graph_logits(params, feats: torch.Tensor, edges: torch.Tensor,
                      cfg: GCNConfig) -> torch.Tensor:
    """``feats (n, F)``, ``edges (2, E)`` int32 -> logits (n, C): each
    layer a dense, then the propagation, then relu but on the last."""
    n = feats.shape[0]
    coef, self_coef = _edge_coefs(edges, n, cfg.norm)
    h = feats.to(cfg.compute_dtype)
    for i, w in enumerate(params["w"]):
        h = layers.dense(w, h, cfg.compute_dtype)
        h = _gcn_propagate(h, edges, coef, self_coef)
        if i < len(params["w"]) - 1:
            h = torch.relu(h)
    return h


def full_graph_loss(params, batch: Dict[str, torch.Tensor],
                    cfg: GCNConfig) -> torch.Tensor:
    """The NLL averaged over the nodes of ``batch["mask"]`` (0/1; every
    node without one)."""
    logits = full_graph_logits(params, batch["feats"], batch["edges"], cfg)
    nll = _nll(logits, batch["labels"])
    mask = batch.get("mask")
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# Minibatch path (neighbour sampling)
# ---------------------------------------------------------------------------


def sample_neighbors(indptr: torch.Tensor, indices: torch.Tensor,
                     nodes: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Uniform-with-replacement neighbour sampling from CSR: ``nodes
    (...,)`` and the draws ``r (..., fanout)`` in [0, 2^30) -> neighbour
    ids ``(..., fanout)``, ``indices[start + r % max(deg, 1)]``; an
    isolated node samples itself. The index is clamped into ``indices``
    before the gather (an isolated node at the end of the CSR starts at
    E), and the node itself is chosen where its degree is 0."""
    start = _take(indptr, nodes)
    deg = _take(indptr, nodes + 1) - start
    offset = r % torch.clamp(deg, min=1)[..., None]
    pos = torch.clamp(start[..., None] + offset, max=indices.shape[0] - 1)
    nbr = _take(indices, pos)
    return torch.where(deg[..., None] > 0, nbr, nodes[..., None])


def minibatch_logits(params, feats, indptr, indices, seeds, rand1, rand2,
                     cfg: GCNConfig) -> torch.Tensor:
    """Two-hop sampled GCN forward for ``seeds (B,)``: hop 1 from
    ``rand1 (B, f1)``, hop 2 from ``rand2 (B, f1, f2)``; logits (B, C)."""
    cd = cfg.compute_dtype
    hop1 = sample_neighbors(indptr, indices, seeds, rand1)       # (B, f1)
    hop2 = sample_neighbors(indptr, indices, hop1, rand2)        # (B, f1, f2)
    x_seed = _take(feats, seeds).to(cd)                     # (B, F)
    x1 = _take(feats, hop1).to(cd)                          # (B, f1, F)
    x2 = _take(feats, hop2).to(cd)                          # (B, f1, f2, F)
    w1 = params["w"][0]
    # layer 1 for hop-1 nodes: mean over their sampled neighbours + self
    h1_nbrs = layers.dense(w1, torch.mean(x2, dim=2), cd)
    h1_self = layers.dense(w1, x1, cd)
    h1 = torch.relu(0.5 * (h1_nbrs + h1_self))                   # (B, f1, H)
    # layer 1 for seeds: mean over hop 1 + self
    h1s = torch.relu(0.5 * (layers.dense(w1, torch.mean(x1, dim=1), cd)
                            + layers.dense(w1, x_seed, cd)))     # (B, H)
    # layer 2 for seeds
    w2 = params["w"][1]
    return 0.5 * (layers.dense(w2, torch.mean(h1, dim=1), cd)
                  + layers.dense(w2, h1s, cd))                   # (B, C)


def minibatch_loss(params, batch: Dict[str, torch.Tensor],
                   cfg: GCNConfig) -> torch.Tensor:
    logits = minibatch_logits(params, batch["feats"], batch["indptr"],
                              batch["indices"], batch["seeds"],
                              batch["rand1"], batch["rand2"], cfg)
    return torch.mean(_nll(logits, batch["labels"]))


# ---------------------------------------------------------------------------
# Batched small graphs (molecule)
# ---------------------------------------------------------------------------


def batched_graphs_logits(params, feats: torch.Tensor, edges: torch.Tensor,
                          cfg: GCNConfig) -> torch.Tensor:
    """``feats (G, N, F)``, ``edges (G, E, 2)`` (graph-local ids) -> (G, C)
    graph logits: the G graphs as one disjoint union (node ids offset by
    g * N) through the full-graph path with symmetric normalisation
    whatever ``cfg.norm`` says (as the reference), then the node mean-pool
    of each graph."""
    g, n = feats.shape[0], feats.shape[1]
    offsets = torch.arange(g, dtype=edges.dtype, device=edges.device) * n
    union = (edges + offsets[:, None, None]).reshape(-1, 2).t().contiguous()
    h = full_graph_logits(params, feats.reshape(g * n, -1), union,
                          dataclasses.replace(cfg, norm="sym"))
    return torch.mean(h.reshape(g, n, -1), dim=1)          # node mean-pool


def batched_graphs_loss(params, batch: Dict[str, torch.Tensor],
                        cfg: GCNConfig) -> torch.Tensor:
    """The binary logistic loss for ``n_classes == 1`` (graph-level 0/1
    labels), else the NLL."""
    out = batched_graphs_logits(params, batch["feats"], batch["edges"], cfg)
    if out.shape[-1] == 1:
        logit = out[:, 0].to(torch.float32)
        y = batch["labels"].to(torch.float32)
        return torch.mean(torch.clamp(logit, min=0) - logit * y
                          + torch.log1p(torch.exp(-torch.abs(logit))))
    return torch.mean(_nll(out, batch["labels"]))
