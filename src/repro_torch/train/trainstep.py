"""Generic train-step builder: a loss function and an optimizer config ->
a step over the port's parameter trees (port of
``repro/train/trainstep.py``)."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch import tree
from repro_torch.train.optimizer import (AdafactorConfig, adafactor_update,
                                         adamw_update, cosine_warmup_lr)

__all__ = ["make_train_step"]


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: the gradient of every
    floating-point leaf of ``params`` (a tree of the same structure; zeros
    where a leaf does not reach the loss; integer leaves get zeros too)."""
    leaves, treedef = tree.flatten(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(p.is_floating_point())
              for p in leaves]
        loss = loss_fn(treedef.unflatten(xs), batch)
        diff = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(loss, diff, allow_unused=True))
    grads = []
    for x in xs:
        g = next(got) if x.requires_grad else None
        grads.append(torch.zeros_like(x) if g is None else g)
    return loss.detach(), treedef.unflatten(grads)


def make_train_step(loss_fn: Callable, opt_cfg, warmup: int = 100,
                    total_steps: int = 10_000, accum_steps: int = 1,
                    accum_dtype: torch.dtype = torch.float32):
    """``loss_fn(params, batch) -> scalar``; returns ``step(params,
    opt_state, batch) -> (params, opt_state, metrics)``.

    The step **consumes** ``params`` and ``opt_state``: the optimizer
    updates them in place and returns them. ``metrics`` (``loss``,
    ``grad_norm``, ``lr``) are device scalars: nothing in a step waits for
    the device. The learning rate follows ``cosine_warmup_lr`` from the
    state's step; the optimizer is AdamW, or Adafactor for an
    ``AdafactorConfig``.

    ``accum_steps > 1``: microbatched accumulation -- the leading batch
    dimension of every batch leaf is cut into (accum, micro), each
    microbatch's gradients are summed in ``accum_dtype``, and the loss and
    the sum are scaled by 1 / accum, so activation memory follows the
    microbatch and the optimizer sees the mean gradient.
    """
    update = adafactor_update if isinstance(opt_cfg, AdafactorConfig) \
        else adamw_update

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if accum_steps == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} does not cut into "
                                 f"{accum_steps} microbatches")
            micro = b // accum_steps
            leaves = tree.leaves(params)
            acc = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                   for p in leaves]
            loss = None
            for i in range(accum_steps):
                mb = {k: v[i * micro:(i + 1) * micro]
                      for k, v in batch.items()}
                loss_i, grads_i = value_and_grad(loss_fn, params, mb)
                loss = loss_i if loss is None else loss + loss_i
                for a, g in zip(acc, tree.leaves(grads_i)):
                    # g in accum_dtype, as the reference rounds it; into an
                    # f32 sum that rounding is exact, so no cast is made
                    a.add_(g if a.dtype in (torch.float32, g.dtype)
                           else g.to(a.dtype))
                del grads_i
            inv = 1.0 / accum_steps
            loss = loss * inv
            for a in acc:
                a.mul_(inv)
            grads = tree.structure(params).unflatten(acc)
        lr = cosine_warmup_lr(opt_state.step, opt_cfg.lr, warmup,
                              total_steps)
        params, opt_state, gnorm = update(grads, opt_state, params, opt_cfg,
                                          lr)
        metrics = {"loss": loss.to(torch.float32), "grad_norm": gnorm,
                   "lr": lr}
        return params, opt_state, metrics

    return train_step
