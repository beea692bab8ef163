"""The process groups and collectives of the LM steps partitioned under
the step bundles' specs: ``transformer.prefill_step`` / ``decode_step`` /
``train_loss`` with ``groups=`` run on one rank's blocks with explicit
collectives, the pattern of the ``vs_*`` steps and DLRM's lookup (the
reference hands the same specs to GSPMD).

Each rank holds the ``sharding.local_block`` of every argument under the
bundle's ``in_specs`` (``transformer.param_specs`` / ``cache_specs`` and
the batch over the data axes) and returns its blocks of the ``out_specs``:

* ``wq`` / ``bq``, ``w_up`` / ``w_gate`` (fsdp, tp): column-parallel, the
  rank's q heads and FFN columns; ``wo``, ``w_down`` (tp, fsdp):
  row-parallel, then one all-reduce (sum) over "model" (:func:`sum_tp`);
* ``wk`` / ``wv`` replicated over tp: every rank makes every KV head, and
  its local q heads attend the KV heads they map to (:func:`local_kv`);
* a dimension cut over the fsdp axes (prefill; MoE decode) is all-gathered
  over them (:func:`gather_dim`) before its layer runs and freed after it;
* ``embed`` (vocab, .): the vocab-parallel lookup
  (``transformer._embed_lookup(tp_group=)``); ``lm_head`` (., vocab): each
  rank's logits over its vocab slice, which the out spec ("batch",
  "vocab") keeps cut (:func:`global_argmax` picks over the whole vocab);
* MoE with ``sharding="ep"``: each rank runs its block of experts on its
  data shard's tokens (replicated over "model"), then the sum over
  "model"; ``sharding="tp"``: every expert on the rank's d_ff columns,
  then the sum, as a dense FFN. The groups of tokens are the whole
  batch's: a group spread over data ranks is routed by one all-gather of
  the choices (``moe.moe_apply(groups=)``);
* the KV cache (., batch, seq_tp, ., .): each "model" rank holds one
  slice of the sequence. Prefill keeps its slice of the trailing
  positions. Decode gathers q over "model" (B x H x dh), attends every
  head over its slice, and combines the slices by their log-sum-exp
  (:func:`lse_combine`); only the rank whose slice holds the new position
  writes its K and V (the windowed ring cache by the same rule), and the
  local heads' columns go on to ``wo``.

Training (``transformer.train_loss`` under ``trainstep.make_train_step``)
runs the same layout under autograd, so each collective is a
``torch.autograd.Function`` whose backward is its transpose:

* :func:`gather_dim`: all-gather forward, reduce-scatter (sum) backward --
  an fsdp weight's gradient arrives at its shard summed over the data
  ranks, and maverick's q columns gathered over "model" send each rank's
  share of every head's gradient back to the rank that holds the column;
* :func:`sum_tp` (Megatron's "g"): all-reduce forward, identity backward,
  after the row-parallel products (``wo``, ``w_down``, the experts' sum),
  the vocab-parallel embedding and the softmax's sums;
* :func:`copy_tp` (Megatron's "f"): identity forward, all-reduce over
  "model" backward, where a value every "model" rank holds enters the
  rank's own share of the work (the normed stream before q / k / v and the
  FFN or the experts, the final norm before the head's vocab slice, the
  MoE gates before the combine, and ``wk`` / ``wv`` / ``bk`` / ``bv``,
  which every rank holds whole but reads only for its local KV heads).
  Every value outside those shares is computed alike on every "model"
  rank, and so is its gradient: a leaf replicated over "model" leaves the
  backward whole on every rank, and the step reduces nothing over "model";
* :func:`max_tp`: the softmax's shift, all-reduce (max) forward and no
  gradient (a log-sum-exp does not depend on its shift);
* :func:`mean_batch`: the MoE load-balance statistics over the whole
  batch, all-reduce forward divided by the data ranks, the gradient passed
  on unscaled (the step takes the mean of the data ranks' gradients).

Under ``torch.no_grad`` (serving) each does what its forward does.

Where a group has one rank its collective is left out, so
:data:`NO_GROUPS` (one process) and a one-rank mesh run the same
operations. Q heads that do not cut whole over "model" (llama4-maverick's
40 over 16) are gathered over "model" and each rank attends the heads its
columns touch. A block that does not divide raises (``local_block``);
nothing is padded.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from repro_torch.models.sharding import sum_over_group

__all__ = ["Groups", "NO_GROUPS", "groups_on", "gather_dim", "sum_tp",
           "copy_tp", "max_tp", "mean_batch", "dim_groups", "spec_leaves",
           "local_kv", "lse_combine", "global_argmax"]


@dataclass(frozen=True)
class Groups:
    """The process groups of a partitioned step: ``tp`` the "model" axis,
    ``batch`` the data axes the batch is cut over, ``fsdp`` those the
    weights' fsdp dimensions are cut over (None where a mesh has no such
    axes), this rank's index and each group's size, and the axis names a
    spec entry gives each: ``tp_axis``, ``batch_axes``, ``fsdp_axes``."""

    tp: Any = None
    batch: Any = None
    fsdp: Any = None
    tp_rank: int = 0
    tp_size: int = 1
    batch_size: int = 1
    fsdp_size: int = 1
    fsdp_axes: Tuple[str, ...] = ()
    tp_axis: Optional[str] = None
    batch_axes: Tuple[str, ...] = ()

    @classmethod
    def of(cls, tp, batch, fsdp, fsdp_axes, tp_axis=None,
           batch_axes=()) -> "Groups":
        import torch.distributed as dist

        def size(g):
            return 1 if g is None else dist.get_world_size(g)

        return cls(tp=tp, batch=batch, fsdp=fsdp,
                   tp_rank=0 if tp is None else dist.get_rank(tp),
                   tp_size=size(tp), batch_size=size(batch),
                   fsdp_size=size(fsdp), fsdp_axes=tuple(fsdp_axes),
                   tp_axis=tp_axis, batch_axes=tuple(batch_axes))


NO_GROUPS = Groups()        # one process: every collective left out


def groups_on(mesh, rules, device_type: str) -> Groups:
    """The :class:`Groups` of ``rules`` (a ``MeshRules``) on the live
    ``DeviceMesh`` of ``mesh`` (``launch.mesh.Mesh``; raises unless a
    process group of ``mesh.size`` ranks is initialized)."""
    from repro_torch.launch import mesh as mesh_mod
    dm = mesh_mod.device_mesh(mesh, device_type)

    def group(axes):
        return mesh_mod.axis_group(dm, axes)

    return Groups.of(group((rules.tp,) if rules.tp else ()),
                     group(rules.dp), group(rules.fsdp), rules.fsdp,
                     tp_axis=rules.tp, batch_axes=rules.dp)


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` forward; its transpose, a reduce-scatter
    (sum) along ``dim``, backward."""

    @staticmethod
    def forward(ctx, x, dim, group, size):
        import torch.distributed as dist
        ctx.dim, ctx.group, ctx.size = dim, group, size
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((size * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        src = grad.movedim(ctx.dim, 0).contiguous()
        out = torch.empty((src.shape[0] // ctx.size,) + tuple(src.shape[1:]),
                          dtype=grad.dtype, device=grad.device)
        dist.reduce_scatter_tensor(out, src, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None, None


def gather_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``dim``, concatenated in rank order
    (one all-gather; its backward reduce-scatters the gradient back to the
    blocks, summed over the ranks); ``x`` itself for one rank."""
    if size == 1:
        return x
    return _GatherDim.apply(x, dim, group, size)


def sum_tp(x: torch.Tensor, g: Groups) -> torch.Tensor:
    """``x`` summed over "model" (one all-reduce; the gradient passed
    through); ``x`` for one rank."""
    return x if g.tp_size == 1 else sum_over_group(x, g.tp)


class _CopyToGroup(torch.autograd.Function):
    """The identity forward; backward, the gradient summed over ``group``
    (each rank holds its share of the gradient of a value all hold)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def copy_tp(x: torch.Tensor, g: Groups) -> torch.Tensor:
    """``x`` entering this "model" rank's share of the work: the identity,
    whose backward sums the ranks' gradients (one all-reduce); ``x`` for
    one rank."""
    return x if g.tp_size == 1 else _CopyToGroup.apply(x, g.tp)


class _MaxOverGroup(torch.autograd.Function):
    """All-reduce (max) forward; no gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return None, None


def max_tp(x: torch.Tensor, g: Groups) -> torch.Tensor:
    """The elementwise largest ``x`` over "model", without a gradient (the
    shift of a vocab-parallel log-sum-exp); ``x`` detached for one
    rank."""
    return x.detach() if g.tp_size == 1 else _MaxOverGroup.apply(x, g.tp)


class _MeanOverGroup(torch.autograd.Function):
    """All-reduce (sum) divided by the ranks forward; the gradient passed
    on unscaled backward."""

    @staticmethod
    def forward(ctx, x, group, size):
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x / size

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def mean_batch(x: torch.Tensor, g: Groups) -> torch.Tensor:
    """The mean of ``x`` over the data ranks (one all-reduce), each rank's
    gradient that of the mean times the ranks: the step averages the
    ranks' gradients, so each rank carries its own share whole; ``x`` for
    one rank."""
    if g.batch_size == 1:
        return x
    return _MeanOverGroup.apply(x, g.batch, g.batch_size)


def dim_groups(spec, g: Groups) -> dict:
    """{dimension: (group, ranks)} of the dimensions of a leaf that
    ``spec`` cuts over a group of ``g`` with more than one rank: an entry
    naming ``tp_axis``, ``fsdp_axes`` or ``batch_axes``; an entry that
    names other axes raises."""
    out = {}
    for d, entry in enumerate(tuple(spec)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        if not axes:
            continue
        if g.tp_axis is not None and axes == (g.tp_axis,):
            grp = (g.tp, g.tp_size)
        elif axes == g.fsdp_axes:
            grp = (g.fsdp, g.fsdp_size)
        elif axes == g.batch_axes:
            grp = (g.batch, g.batch_size)
        else:
            raise ValueError(f"no process group for the axes {axes} of "
                             f"{spec}")
        if grp[1] > 1:
            out[d] = grp
    return out


def spec_leaves(specs) -> list:
    """The leaf specs of a spec tree (dicts of ``PartitionSpec``s), in the
    order ``repro_torch.tree`` flattens the tree they describe (dict keys
    sorted)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [specs]


def local_kv(h0: int, n_q: int, n_heads: int, n_kv: int):
    """The KV heads that q heads ``[h0, h0 + n_q)`` attend (q head h reads
    KV head ``h // (n_heads / n_kv)``), as (KV heads in order, the local
    GQA group). Uniform where the local heads fill whole KV groups or lie
    in one; otherwise one KV head a q head (group 1, repeats allowed)."""
    grp = n_heads // n_kv
    first, last = h0 // grp, (h0 + n_q - 1) // grp
    if first == last:
        return [first], n_q
    if h0 % grp == 0 and n_q % grp == 0:
        return list(range(first, last + 1)), grp
    return [h // grp for h in range(h0, h0 + n_q)], 1


def lse_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, group,
                size: int) -> torch.Tensor:
    """Flash-decoding's combine of the ranks' partial attentions over their
    slices of the sequence: ``m`` (..., 1) each rank's largest score,
    ``l`` (..., 1) its sum of ``exp(score - m)``, ``o`` (..., dh) its sum
    of ``exp(score - m) v``. One all-reduce of the maxima, one of the
    rescaled sums and outputs; returns the softmax-weighted output."""
    import torch.distributed as dist
    top = m.clone()
    if size > 1:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    scale = torch.exp(m - top)
    both = torch.cat([l * scale, o * scale], dim=-1)
    if size > 1:
        dist.all_reduce(both, group=group)
    return both[..., 1:] / both[..., :1]


def global_argmax(logits: torch.Tensor, g: Groups) -> torch.Tensor:
    """The index over the whole vocab of each row's largest logit, from
    the ranks' vocab slices ``logits (B, V / tp)`` (the first on a tie, as
    ``torch.argmax`` over the whole row)."""
    idx = torch.argmax(logits, dim=-1)
    if g.tp_size == 1:
        return idx
    val = torch.gather(logits, 1, idx[:, None])
    idx = idx[:, None] + g.tp_rank * logits.shape[1]
    vals = gather_dim(val, 1, g.tp, g.tp_size)           # (B, tp)
    idxs = gather_dim(idx, 1, g.tp, g.tp_size)
    return torch.gather(idxs, 1, torch.argmax(vals, dim=1,
                                              keepdim=True))[:, 0]
