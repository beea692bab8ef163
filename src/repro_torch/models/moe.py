"""Mixture-of-Experts feed-forward layer (GShard-style grouped dispatch),
from the reference's ``repro/models/moe.py``.

Serves the two MoE architectures of ``configs/``: grok-1-314b (8 experts,
top-2) and llama4-maverick-400b-a17b (128 experts, top-1).

Tokens are processed in fixed-size groups (GShard): per group of T_g
tokens, each expert has capacity C = int(T_g * top_k * capacity_factor /
E) + 1 rounded up to a multiple of 4 (at least 4). The K choices of a
token claim slots in priority order: every token's first choice before
any token's second, each by a running count over the group's tokens; a
choice whose slot is at or past C is dropped, and its token keeps only its
other choices (the residual stream carries a token with none). The router
runs in f32; the expert products in ``compute_dtype``. The auxiliary loss
is the Switch / GShard load-balance loss E * sum_e f_e * p_e over the
first choices.

Where the reference builds (G, T_g, E, C) one-hot ``dispatch`` and
``combine`` tensors and contracts them with einsums, this port scatters
each kept choice's token row into an (E, G, C, D) buffer by its slot index
and gathers each choice's expert output back from it: the same slots, the
same drops, the same sums (the combine is each token's K gate-weighted
rows added in f32 and rounded to ``compute_dtype`` once, as the einsum
does). The expert products are batched matrix products over E, which the
reference also leaves to its einsums: no Pallas kernel is reached.

``MoEConfig.sharding`` ("ep" | "tp") picks the experts' partition specs
(``transformer.param_logical_axes``); the computation is the same under
either, and the reference's ``constrain`` hints change no value.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.partitioned import (NO_GROUPS, Groups, copy_tp,
                                            mean_batch)

__all__ = ["MoEConfig", "Routing", "moe_init", "route", "moe_apply"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 256
    sharding: str = "ep"          # "ep" | "tp": the experts' specs
    aux_loss_weight: float = 0.01


def moe_init(d_model: int, d_ff: int, cfg: MoEConfig, glu: bool, dtype,
             generator: torch.Generator, device=None,
             n_stack: Optional[int] = None):
    """Random expert parameters at the reference's scales: ``router`` (D,
    E) and ``w_up`` / ``w_gate`` (E, D, F) times D^-1/2, ``w_down`` (E, F,
    D) times F^-1/2, in ``dtype``, drawn on ``device`` (the GPU unless
    ``device="cpu"``) from ``generator``, which must live on that device.
    With ``n_stack`` every leaf gets a leading axis of that many layers, as
    the transformer stacks them."""
    dev = layers.generator_device(generator, device)
    lead = () if n_stack is None else (n_stack,)
    e = cfg.n_experts

    def normal(shape, scale):
        return torch.randn(lead + shape, generator=generator, device=dev,
                           dtype=dtype).mul_(scale)

    p = {"router": normal((d_model, e), d_model ** -0.5),
         "w_up": normal((e, d_model, d_ff), d_model ** -0.5),
         "w_down": normal((e, d_ff, d_model), d_ff ** -0.5)}
    if glu:
        p["w_gate"] = normal((e, d_model, d_ff), d_model ** -0.5)
    return p


def _capacity(tg: int, cfg: MoEConfig) -> int:
    c = int(tg * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(4, -(-c // 4) * 4)


class Routing(NamedTuple):
    """The router's decisions for tokens in groups (G, T_g): ``probs`` (G,
    T_g, E) f32; per choice (G, T_g, K): the expert ``idx``, the
    renormalised ``gates`` f32, the slot ``pos`` in that expert's buffer of
    ``capacity`` and ``keep`` (pos < capacity)."""

    probs: torch.Tensor
    idx: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def _slots(idx: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """Each choice's slot ``pos`` (G, T_g, K) in its expert's buffer: the
    choices claim slots in priority order (every token's first choice
    before any token's second), each by a running count over the group's
    tokens of the choices at that priority that were kept."""
    counts = torch.zeros(idx.shape[0], 1, e, dtype=torch.int64,
                         device=idx.device)
    pos = []
    for slot in range(idx.shape[-1]):
        onehot = F.one_hot(idx[..., slot], e)                 # (G, Tg, E)
        p = (torch.cumsum(onehot, dim=1) - 1 + counts).gather(
            -1, idx[..., slot:slot + 1])                      # (G, Tg, 1)
        pos.append(p)
        counts = counts + (onehot * (p < cap)).sum(1, keepdim=True)
    return torch.cat(pos, dim=-1)


def _router(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig):
    """Softmax router in f32 on tokens ``x (..., D)``: (probs, the
    renormalised top-k gates, their experts)."""
    logits = x.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def route(router: torch.Tensor, xg: torch.Tensor, cfg: MoEConfig) -> Routing:
    """Softmax router in f32 and slot assignment in priority order for
    tokens ``xg (G, T_g, D)``."""
    probs, gates, idx = _router(router, xg, cfg)
    cap = _capacity(xg.shape[1], cfg)
    pos = _slots(idx, cfg.n_experts, cap)
    return Routing(probs, idx, gates, pos, pos < cap, cap)


def _spread_route(router: torch.Tensor, xt: torch.Tensor, cfg: MoEConfig,
                  tg: int, group, size: int):
    """:func:`route` of groups of ``tg`` tokens spread over the ``size``
    ranks of ``group``: this rank's ``xt (t, D)`` are tokens ``[rank * t,
    (rank + 1) * t)`` of the ranks' concatenation, and a group holds whole
    blocks (``tg % t == 0``). Each rank routes its tokens, one all-gather
    of the choices gives every rank the groups' running counts, and each
    keeps its own tokens' slots: the one-process routing of the whole
    batch. Returns (Routing over (1, t, ...), each token's group (t,))."""
    import torch.distributed as dist
    t = xt.shape[0]
    probs, gates, idx = _router(router, xt, cfg)
    every = torch.empty((size * t, cfg.top_k), dtype=idx.dtype,
                        device=idx.device)
    dist.all_gather_into_tensor(every, idx.contiguous(), group=group)
    cap = _capacity(tg, cfg)
    rank = dist.get_rank(group)
    pos = _slots(every.view(-1, tg, cfg.top_k), cfg.n_experts, cap)
    pos = pos.reshape(-1, cfg.top_k)[rank * t:(rank + 1) * t]
    tok_group = (rank * t + torch.arange(t, device=xt.device)) // tg
    return (Routing(probs[None], idx[None], gates[None], pos[None],
                    (pos < cap)[None], cap), tok_group)


def _experts(params, x_e: torch.Tensor, act: str, glu: bool,
             cd) -> torch.Tensor:
    """The expert FFNs on their slot rows ``x_e (E, N, D)``: batched
    products over E in ``cd``. Each weight's cast is a temporary, so a
    compute type other than the weights' holds one cast weight at a
    time."""
    h = torch.bmm(x_e, params["w_up"].to(cd))                 # (E, N, F)
    if glu:
        h = layers.activation(act, torch.bmm(
            x_e, params["w_gate"].to(cd))) * h
    else:
        h = layers.activation(act, h)
    return torch.bmm(h, params["w_down"].to(cd))


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig, act: str, glu: bool,
              compute_dtype=torch.bfloat16, groups: Groups = NO_GROUPS,
              whole_aux: bool = False):
    """``x (..., D)`` -> (y in x's shape and type, aux loss f32 scalar).
    The leading dims are flattened to tokens in row-major order and cut
    into groups of ``min(group_size, tokens)``; a token count that is not a
    multiple of the group raises ``ValueError``, where the reference
    asserts.

    The partitioned steps pass ``groups`` (``partitioned.Groups``). Under
    ``sharding="ep"`` ``params`` holds this "model" rank's block of the
    experts; the other experts' choices keep their slots but are left out
    here. Under "tp" it holds every expert's block of d_ff columns. Either
    way the ranks' outputs summed over "model" make the whole layer's (the
    caller sums them), and the tokens and the gates enter the rank's share
    through ``partitioned.copy_tp``, so their gradients are summed over
    "model"; the router runs alike on every rank. The data ranks' token
    blocks (this rank's ``x`` is block ``rank``) make the batch: groups
    are cut over the whole batch and routed as one process routes it
    (:func:`_spread_route` where a group spans ranks). The auxiliary loss
    is this rank's tokens' (serving drops it), or with ``whole_aux`` the
    whole batch's, its statistics averaged over the data ranks
    (``partitioned.mean_batch``), as training needs it."""
    cd = compute_dtype
    shape, d = x.shape, x.shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    group, size = groups.batch, groups.batch_size
    tg = min(cfg.group_size, t * size)
    if (t * size) % tg:
        raise ValueError(f"token count {t * size} not divisible by group "
                         f"{tg}")
    e, k = cfg.n_experts, cfg.top_k
    e0, e_here = 0, e
    if cfg.sharding == "ep" and groups.tp_size > 1:
        e_here = params["w_up"].shape[0]
        e0 = groups.tp_rank * e_here
    if t % tg == 0:                     # every group on this rank
        g = t // tg
        xg = xt.reshape(g, tg, d)
        r = route(params["router"], xg, cfg)
        tok_group = torch.arange(g, device=x.device)[:, None, None]
    elif tg % t == 0:                   # a group spans whole ranks' blocks
        r, tok_group = _spread_route(params["router"], xt, cfg, tg, group,
                                     size)
        g = size * t // tg
        xg = xt[None]
        tok_group = tok_group[None, :, None]
    else:
        raise ValueError(f"{t} tokens a rank do not cut into groups of "
                         f"{tg}")
    cap = r.capacity

    # dispatch: each kept choice of this rank's experts, its token row into
    # the expert's slot of an (E, G, C, D) buffer; dropped choices (and
    # other ranks' experts') go to one spare row past its end (no host
    # sync for a mask)
    n_slots = e_here * g * cap
    mine = r.keep & (r.idx >= e0) & (r.idx < e0 + e_here)
    rows = torch.where(mine, ((r.idx - e0) * g + tok_group) * cap + r.pos,
                       n_slots)
    n_tok = xg.shape[0] * xg.shape[1]
    src = copy_tp(xg, groups).to(cd)[:, :, None, :].expand(
        *xg.shape[:2], k, d).reshape(-1, d)
    buf = torch.zeros(n_slots + 1, d, dtype=cd, device=x.device)
    buf.index_copy_(0, rows.reshape(-1), src)
    x_e = buf[:n_slots].view(e_here, g * cap, d)

    y_e = _experts(params, x_e, act, glu, cd).view(n_slots, d)

    # combine: each token's K expert rows weighted by its gates (cast to
    # compute_dtype, 0 for a dropped choice), summed in f32, rounded once
    w = torch.where(mine, copy_tp(r.gates, groups), 0.0).to(cd)
    picked = y_e[torch.where(mine, rows, 0).reshape(-1)].view(n_tok, k, d)
    y = torch.bmm(w.view(n_tok, 1, k), picked).view(t, d)

    frac = F.one_hot(r.idx[..., 0], e).to(torch.float32).mean(dim=(0, 1))
    mean_probs = r.probs.mean(dim=(0, 1))
    if whole_aux:
        frac, mean_probs = mean_batch(frac, groups), mean_batch(mean_probs,
                                                                groups)
    aux = cfg.aux_loss_weight * e * torch.sum(frac * mean_probs)
    return y.reshape(shape).to(x.dtype), aux
