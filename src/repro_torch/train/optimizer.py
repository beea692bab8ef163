"""AdamW and Adafactor over the port's parameter trees (port of
``repro/train/optimizer.py``).

States are NamedTuples of trees shaped like the parameters, so
:mod:`repro_torch.tree` and :mod:`repro_torch.train.checkpoint` walk them
by field, as the reference's pytrees. The arithmetic per element is the
reference's, in f32; a new parameter is rounded back to its own type.

Unlike the reference's pure functions, the updates work **in place**:
they consume ``params`` and ``state`` and return the same tensors
updated (``grads`` are only read). A leaf is updated slice by slice along its first
axis (the layer axis of a stacked tensor), so the f32 temporaries of an
update are those of one slice, never of a whole stack: at h2o-danube-3-4b's
width a second copy of 7.9 GB of bf16 parameters and 31.7 GB of f32
moments would not fit beside the first on one card. The reference's own
note on Adafactor records that update temporaries mattered on its chips
too.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch import tree
from repro_torch.models.partitioned import (NO_GROUPS, Groups, dim_groups,
                                            spec_leaves)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "AdafactorConfig", "AdafactorState", "adafactor_init",
           "adafactor_update", "global_norm", "cosine_warmup_lr"]

# Elements of f32 temporaries an update makes at once: a slice of a leaf's
# first axis, or several whole slices up to this many elements.
SLICE_ELEMENTS = 1 << 26


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: object              # f32 tree like params
    nu: object


def adamw_init(params) -> AdamWState:
    leaves, treedef = tree.flatten(params)
    dev = leaves[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=treedef.unflatten([torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device) for p in leaves]),
        nu=treedef.unflatten([torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device) for p in leaves]))


def _slices(*tensors):
    """Matching slices of same-shaped tensors along their first axis,
    each at most ``SLICE_ELEMENTS`` elements where the axis allows."""
    t0 = tensors[0]
    if t0.ndim == 0 or t0.numel() <= SLICE_ELEMENTS:
        yield tensors
        return
    per = max(1, SLICE_ELEMENTS // max(1, t0[0].numel()))
    for i in range(0, t0.shape[0], per):
        yield tuple(t[i:i + per] for t in tensors)


def _leaf_cuts(params, groups: Groups, specs) -> list:
    """Each leaf's ``partitioned.dim_groups`` (its dimensions cut over a
    group of more than one rank), in leaf order; all empty in one
    process."""
    n = len(tree.leaves(params))
    if specs is None or groups == NO_GROUPS:
        return [{}] * n
    cuts = [dim_groups(s, groups) for s in spec_leaves(specs)]
    if len(cuts) != n:
        raise ValueError("the specs do not have the parameters' structure")
    return cuts


def _sum_over(x: torch.Tensor, cut: dict) -> torch.Tensor:
    """``x`` (a rank's partial sum) summed over each distinct group of
    ``cut``, in place: one all-reduce a group."""
    import torch.distributed as dist
    seen = []
    for group, _ in cut.values():
        if all(group is not g for g in seen):
            seen.append(group)
            dist.all_reduce(x, group=group)
    return x


def global_norm(grads, groups: Groups = NO_GROUPS, specs=None
                ) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a device scalar);
    a large leaf is read slice by slice (no f32 copy of it). Under
    ``groups`` ``grads`` is one rank's blocks under ``specs``: the leaves
    cut alike add their squares, each such sum is summed over the groups
    that cut them, and a leaf replicated over a group counts once."""
    by_cut = {}                 # the leaves cut over the same groups
    for g, cut in zip(tree.leaves(grads), _leaf_cuts(grads, groups, specs)):
        key = frozenset(id(group) for group, _ in cut.values())
        for (gs,) in _slices(g):
            sq = torch.sum(torch.square(gs.to(torch.float32)))
            if key in by_cut:
                sq = by_cut[key][0] + sq
            by_cut[key] = (sq, cut)
    total = None
    for sq, cut in by_cut.values():
        sq = _sum_over(sq, cut) if cut else sq
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def cosine_warmup_lr(step: torch.Tensor, base_lr: float, warmup: int = 100,
                     total: int = 10_000,
                     min_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    to ``min_frac * base_lr`` at ``total``; a device scalar (no sync)."""
    stepf = step.to(torch.float32)
    warm = stepf / max(warmup, 1)
    prog = torch.clamp((stepf - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(stepf < warmup, warm, cos)


def _flat(ref, *trees):
    leaves, treedef = tree.flatten(ref)
    others = []
    for t in trees:
        ls, td = tree.flatten(t)
        if td != treedef:
            raise ValueError("the trees do not have the parameters' "
                             "structure")
        others.append(ls)
    return leaves, others


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None,
                 groups: Groups = NO_GROUPS, specs=None):
    """One AdamW step, in place: global-norm clip, bias-corrected moments,
    decoupled weight decay on the f32 parameter. Consumes ``params`` and
    ``state`` (updated and returned) and leaves ``grads`` as given.
    Returns (params, state, grad_norm). Elementwise, so a rank's shards
    (under ``groups`` and the parameters' ``specs``) update alone; only
    the clip's norm is over the whole tree (:func:`global_norm`)."""
    gnorm = global_norm(grads, groups, specs)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    state.step.add_(1)
    stepf = state.step.to(torch.float32)
    lr_t = cfg.lr if lr is None else lr
    bc1 = 1.0 - torch.pow(cfg.b1, stepf)
    bc2 = 1.0 - torch.pow(cfg.b2, stepf)
    leaves, (gs, ms, vs) = _flat(params, grads, state.mu, state.nu)
    for p, g, m, v in zip(leaves, gs, ms, vs):
        for ps, gs_, mss, vss in _slices(p, g, m, v):
            gf = gs_.to(torch.float32)
            if scale is not None:
                gf = gf * scale
            mss.copy_(cfg.b1 * mss + (1 - cfg.b1) * gf)
            vss.copy_(cfg.b2 * vss + (1 - cfg.b2) * gf * gf)
            pf = ps.to(torch.float32)
            upd = (mss / bc1) / (torch.sqrt(vss / bc2) + cfg.eps) \
                + cfg.weight_decay * pf
            ps.copy_(pf - lr_t * upd)
    return params, state, gnorm


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018): a factored second moment for leaves of
# two or more dimensions (row and column means over the last two axes) and
# optional momentum in ``momentum_dtype``.
# ---------------------------------------------------------------------------


class AdafactorConfig(NamedTuple):
    lr: float = 1e-2
    decay: float = 0.8            # beta2 exponent: 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0   # update RMS clip
    weight_decay: float = 0.0
    momentum: Optional[float] = None    # None = no first moment
    momentum_dtype: torch.dtype = torch.bfloat16


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: object    # row second moments (factored leaves) / full v (vectors)
    vc: object    # column second moments (a (1,)-shaped zero for vectors)
    mu: object    # momentum, or a (1,)-shaped zero placeholder


def _factored(p) -> bool:
    return p.ndim >= 2


def adafactor_init(params, cfg: AdafactorConfig = AdafactorConfig()
                   ) -> AdafactorState:
    leaves, treedef = tree.flatten(params)
    f32 = torch.float32

    def vr(p):
        return torch.zeros(p.shape[:-1] if _factored(p) else p.shape,
                           dtype=f32, device=p.device)

    def vc(p):
        shape = (p.shape[:-2] + p.shape[-1:] if _factored(p)
                 else (1,) * max(p.ndim, 1))
        return torch.zeros(shape, dtype=f32, device=p.device)

    def mu(p):
        return torch.zeros(p.shape if cfg.momentum is not None else (1,),
                           dtype=cfg.momentum_dtype, device=p.device)

    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        vr=treedef.unflatten([vr(p) for p in leaves]),
        vc=treedef.unflatten([vc(p) for p in leaves]),
        mu=treedef.unflatten([mu(p) for p in leaves]))


def _mean(x: torch.Tensor, dim: int, cut, keepdim: bool = False):
    """The mean of ``x`` over ``dim``; where ``cut`` (group, ranks) cuts
    that dimension, the mean over the whole of it (one all-reduce of the
    ranks' means, divided by the ranks)."""
    m = torch.mean(x, dim=dim, keepdim=keepdim)
    if cut is None:
        return m
    import torch.distributed as dist
    dist.all_reduce(m, group=cut[0])
    return m.div_(cut[1])


def _second_moments(g, vr, vc, beta2, cfg: AdafactorConfig, cut=None):
    """One leaf's (or one slice's) new ``vr`` and ``vc`` from its gradient
    and its unclipped update ``g / sqrt(v-hat)``: (u, vr, vc). ``cut``:
    the leaf's ``partitioned.dim_groups``; a row or column mean over a
    dimension a group cuts is that of the whole dimension."""
    gf = g.to(torch.float32)
    g2 = gf * gf + cfg.eps
    if _factored(g):
        cut = cut or {}
        rows, cols = cut.get(g.ndim - 2), cut.get(g.ndim - 1)
        vr = beta2 * vr + (1 - beta2) * _mean(g2, -1, cols)
        vc = beta2 * vc + (1 - beta2) * _mean(g2, -2, rows)
        denom = torch.clamp(_mean(vr, -1, rows, keepdim=True), min=cfg.eps)
        vhat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
    else:
        vr = beta2 * vr + (1 - beta2) * g2
        vhat = vr
    return gf * torch.rsqrt(vhat + cfg.eps), vr, vc


@torch.no_grad()
def adafactor_update(grads, state: AdafactorState, params,
                     cfg: AdafactorConfig = AdafactorConfig(),
                     lr: Optional[torch.Tensor] = None,
                     groups: Groups = NO_GROUPS, specs=None):
    """One Adafactor step, in place (consumes ``params`` and ``state``).
    A leaf's update is clipped by its RMS over the whole leaf, so a leaf of
    three or more axes that is cut into slices along its first axis (a
    batch axis of its factored moments) is read twice: once for the RMS,
    once to apply it. Under ``groups`` each leaf is a rank's block under
    its spec (``specs``, the parameters'; the moments' blocks follow
    ``steps._adafactor_specs``): a row or column mean, and the mean of
    ``vr`` in the denominator, over a dimension a group cuts is reduced
    over that group, and the RMS is the whole leaf's (its squares summed
    over every group that cuts it). Returns (params, state, grad_norm)."""
    gnorm = global_norm(grads, groups, specs)
    state.step.add_(1)
    beta2 = 1.0 - torch.pow(state.step.to(torch.float32), -cfg.decay)
    lr_t = cfg.lr if lr is None else lr
    leaves, (gs, vrs, vcs, mus) = _flat(params, grads, state.vr, state.vc,
                                        state.mu)
    cuts = _leaf_cuts(params, groups, specs)
    for p, g, vr, vc, mu, cut in zip(leaves, gs, vrs, vcs, mus, cuts):
        sliced = p.ndim >= 3 and p.numel() > SLICE_ELEMENTS
        n_whole = p.numel()
        for _, size in cut.values():
            n_whole *= size

        def rms_of(sq):
            return torch.sqrt(_sum_over(sq, cut) / n_whole + cfg.eps)

        rms = None
        if sliced:
            sq = None
            for g_s, vr_s, vc_s in _slices(g, vr, vc):
                u = _second_moments(g_s, vr_s, vc_s, beta2, cfg, cut)[0]
                part = torch.sum(u * u)
                sq = part if sq is None else sq + part
            rms = rms_of(sq)
        parts = _slices(p, g, vr, vc) if sliced else [(p, g, vr, vc)]
        row = 0
        for p_s, g_s, vr_s, vc_s in parts:
            u, vr_new, vc_new = _second_moments(g_s, vr_s, vc_s, beta2, cfg,
                                                cut)
            vr_s.copy_(vr_new)
            if _factored(p):
                vc_s.copy_(vc_new)
            if rms is not None:
                rms_s = rms
            elif cut:
                rms_s = rms_of(torch.sum(u * u))
            else:
                rms_s = torch.sqrt(torch.mean(u * u) + cfg.eps)
            u = u / torch.clamp(rms_s / cfg.clip_threshold, min=1.0)
            if cfg.momentum is not None:
                mu_s = mu[row:row + p_s.shape[0]] if sliced else mu
                u = cfg.momentum * mu_s.to(torch.float32) \
                    + (1 - cfg.momentum) * u
                mu_s.copy_(u.to(cfg.momentum_dtype))
            row += p_s.shape[0] if p_s.ndim else 0
            pf = p_s.to(torch.float32)
            p_s.copy_(pf - lr_t * u - lr_t * cfg.weight_decay * pf)
    return params, state, gnorm
