"""Generic train-step builder: a loss function and an optimizer config ->
a step over the port's parameter trees (port of
``repro/train/trainstep.py``)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.models.partitioned import NO_GROUPS, Groups, spec_leaves
from repro_torch.train.optimizer import (AdafactorConfig, adafactor_update,
                                         adamw_update, cosine_warmup_lr)

__all__ = ["make_train_step", "value_and_grad", "rank_major"]


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


def rank_major(batch: Dict[str, torch.Tensor], accum_steps: int,
               n_ranks: int) -> Dict[str, torch.Tensor]:
    """The batch laid out for ``n_ranks`` data ranks under a batch spec:
    the rows reordered so that rank r's contiguous block (its
    ``sharding.local_block``) holds, in order, its block of each of the
    ``accum_steps`` microbatches. The partitioned step then cuts each
    rank's rows into consecutive microbatches, and microbatch i over the
    ranks is the one-process step's microbatch i of ``batch``."""
    if accum_steps == 1 or n_ranks == 1:
        return batch

    def order(x):
        b = x.shape[0]
        if b % (accum_steps * n_ranks):
            raise ValueError(f"batch {b} does not cut into {accum_steps} "
                             f"microbatches over {n_ranks} ranks")
        return x.reshape((accum_steps, n_ranks, b // (accum_steps * n_ranks))
                         + tuple(x.shape[1:])).transpose(0, 1).reshape(
                             x.shape)

    return {k: order(v) for k, v in batch.items()}


def _reduce_grads(grads, groups: Groups, specs, scale: float) -> None:
    """In place: each gradient leaf of one rank summed over the data ranks
    -- an fsdp leaf arrives summed (``gather_dim``'s reduce-scatter), every
    other leaf is all-reduced here -- and times ``scale``."""
    if groups.batch_size > 1:
        import torch.distributed as dist
        if groups.fsdp_axes not in ((), groups.batch_axes):
            raise ValueError(f"fsdp over {groups.fsdp_axes}, the batch over "
                             f"{groups.batch_axes}: training cuts both over "
                             "the same axes")
        for g, spec in zip(tree.leaves(grads), spec_leaves(specs)):
            if not (groups.fsdp_axes and groups.fsdp_axes in tuple(spec)):
                dist.all_reduce(g, group=groups.batch)
    if scale != 1.0:
        for g in tree.leaves(grads):
            g.mul_(scale)


def make_train_step(loss_fn: Callable, opt_cfg, warmup: int = 100,
                    total_steps: int = 10_000, accum_steps: int = 1,
                    accum_dtype: torch.dtype = torch.float32,
                    groups: Optional[Groups] = None, specs=None):
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

    With ``groups`` (``partitioned.Groups``) and ``specs`` (the parameter
    tree's specs) the step runs on one rank's blocks: ``params``, the
    optimizer state and ``batch`` (laid out by :func:`rank_major`) are its
    blocks, and ``loss_fn`` its loss on them (``transformer.train_loss``
    with the same groups: its rows' mean, every collective inside). Each
    leaf's gradient is then reduced by its spec: an fsdp leaf arrives
    summed over the data ranks from ``gather_dim``'s backward (a
    reduce-scatter each microbatch), every leaf replicated over the data
    ranks is all-reduced over them once a step, and both are scaled to the
    mean over the data ranks. Nothing is reduced over "model": the loss's
    backward leaves each rank its blocks' whole gradient (``models/
    partitioned.py``). The loss metric is the data ranks' mean; the
    optimizer runs on the rank's shards (``optimizer.global_norm`` and
    Adafactor's means reduced over the groups that cut them). Where every
    group has one rank this is the one-process step, operation for
    operation.
    """
    groups = NO_GROUPS if groups is None else groups
    if groups != NO_GROUPS and specs is None:
        raise ValueError("a partitioned step needs the parameters' specs")
    update = adafactor_update if isinstance(opt_cfg, AdafactorConfig) \
        else adamw_update

    def grads_of(params, batch: Dict[str, torch.Tensor]):
        """(loss, gradient tree) of one step: accumulated over the
        microbatches, reduced over the data ranks, the mean."""
        if accum_steps == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
            _reduce_grads(grads, groups, specs, 1.0 / groups.batch_size)
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
            grads = tree.structure(params).unflatten(acc)
            _reduce_grads(grads, groups, specs, inv / groups.batch_size)
        if groups.batch_size > 1:
            import torch.distributed as dist
            dist.all_reduce(loss, group=groups.batch)
            loss = loss / groups.batch_size
        return loss, grads

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        loss, grads = grads_of(params, batch)
        lr = cosine_warmup_lr(opt_state.step, opt_cfg.lr, warmup,
                              total_steps)
        params, opt_state, gnorm = update(grads, opt_state, params, opt_cfg,
                                          lr, groups=groups, specs=specs)
        metrics = {"loss": loss.to(torch.float32), "grad_norm": gnorm,
                   "lr": lr}
        return params, opt_state, metrics

    train_step.grads = grads_of
    return train_step
