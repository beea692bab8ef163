"""Sharding rules: logical tensor roles -> partition specs (port of
``repro/models/sharding.py``).

Axes (the production meshes, ``launch/mesh.py``):
  * ``data``  -- batch / tokens / database rows (composed with ``pod``)
  * ``model`` -- tensor parallel: attention heads, FFN hidden, vocab, experts
  * ``pod``   -- outermost data parallelism across pods (multi-pod only)

``MeshRules`` resolves the axis names present in a mesh, so the same model
code gets its specs on the single-pod (data, model) and the multi-pod
(pod, data, model) meshes and on the 1-D host mesh. A spec is a
:class:`PartitionSpec`: one entry a dimension, each None (replicated), an
axis name or a tuple of names (the dimension cut over their product, the
first name outermost). It is a tuple, and compares equal to the
reference's ``jax.sharding.PartitionSpec`` of the same entries.

Where the reference hands its specs to XLA (``in_shardings``, and
``with_sharding_constraint`` through ``constrain``), the port runs its
explicit collectives over ``torch.distributed`` process groups
(``embedding.make_sharded_lookup``, ``transformer._embed_lookup``, the
``vs_search`` merge in ``launch/steps.py``) and reads a spec in two ways:
:func:`placements`, the ``torch.distributed.tensor`` placements of a
spec on a live ``DeviceMesh``, and :func:`local_block`, the block of a
full tensor that one mesh position holds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch

AxisSel = Union[None, str, Tuple[str, ...]]

__all__ = ["PartitionSpec", "P", "MeshRules", "logical_to_spec", "constrain",
           "placements", "local_block", "sum_over_group"]


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: entry i says how dimension i is cut
    (None, an axis name or a tuple of axis names); dimensions past the last
    entry are replicated."""

    def __new__(cls, *entries: AxisSel):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class MeshRules:
    """Logical-axis -> mesh-axis mapping.

    ``dp``: pure data-parallel axes (batch dim); ``fsdp``: axes that also
    shard parameters and optimizer state (ZeRO-3), a subset of dp; ``tp``:
    the tensor-parallel axis; ``ep``: the expert-parallel axis (MoE;
    usually ``tp``)."""

    dp: Tuple[str, ...] = ("data",)
    fsdp: Tuple[str, ...] = ("data",)
    tp: Optional[str] = "model"
    ep: Optional[str] = "model"

    @classmethod
    def for_mesh(cls, mesh, fsdp: bool = True) -> "MeshRules":
        """The rules of ``mesh`` (anything with ``axis_names``): dp every
        data axis present ("pod", "data"), tp and ep "model" if present.
        ZeRO-3 spans every data-parallel axis."""
        names = mesh.axis_names
        dp = tuple(a for a in ("pod", "data") if a in names)
        tp = "model" if "model" in names else None
        return cls(dp=dp or (), fsdp=(dp if fsdp else ()), tp=tp, ep=tp)

    def batch(self, *rest: AxisSel) -> PartitionSpec:
        return P(self.dp if self.dp else None, *rest)

    def replicated(self) -> PartitionSpec:
        return P()


def logical_to_spec(rules: MeshRules,
                    logical: Sequence[Optional[str]]) -> PartitionSpec:
    """Per-dimension logical names -> a spec. Names: "batch", "fsdp",
    "tp", "ep", "vocab" (= tp), "seq_tp" (the decode KV cache's sequence
    dim over tp), None (replicated); any other raises ``ValueError``."""
    out = []
    for name in logical:
        if name is None:
            out.append(None)
        elif name == "batch":
            out.append(rules.dp if rules.dp else None)
        elif name == "fsdp":
            out.append(rules.fsdp if rules.fsdp else None)
        elif name in ("tp", "vocab", "seq_tp"):
            out.append(rules.tp)
        elif name == "ep":
            out.append(rules.ep)
        else:
            raise ValueError(f"unknown logical axis {name!r}")
    return P(*out)


def constrain(x: torch.Tensor, rules: MeshRules,
              logical: Sequence[Optional[str]]) -> torch.Tensor:
    """The reference's layout hint (``with_sharding_constraint`` by
    logical names): it changes no value, only how XLA places one, so here
    it is the identity."""
    return x


def _axes(entry: AxisSel) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence[AxisSel], device_mesh) -> list:
    """The ``torch.distributed.tensor`` placements of ``spec`` on a live
    ``DeviceMesh`` (one a mesh dimension): ``Shard(d)`` on every mesh
    dimension that cuts tensor dimension d, ``Replicate()`` on the rest. A
    tensor dimension cut over several mesh dimensions is cut in mesh order,
    which is the spec's order when its names follow the mesh's (as every
    spec of :class:`MeshRules` does)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            if a not in names:
                raise ValueError(f"mesh axis {a!r} is not in {names}")
            out[names.index(a)] = Shard(d)
    return out


def local_block(t: torch.Tensor, spec: Sequence[AxisSel], mesh,
                coords: Mapping[str, int]) -> torch.Tensor:
    """The block of the full tensor ``t`` that the mesh position
    ``coords`` ({axis name: index}) holds under ``spec``, as a view: each
    cut dimension in equal contiguous chunks, the chunk of a dimension cut
    over several axes numbered row-major over them (the reference's
    ``NamedSharding``). ``mesh`` is anything with a ``shape`` mapping of
    axis sizes. Raises ``ValueError`` where a dimension does not divide."""
    index = []
    for d, entry in enumerate(tuple(spec) + (None,) * (t.ndim - len(spec))):
        n, pos = 1, 0
        for a in _axes(entry):
            n *= mesh.shape[a]
            pos = pos * mesh.shape[a] + coords[a]
        if t.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(t.shape)} does not "
                             f"cut into {n} equal blocks ({spec})")
        size = t.shape[d] // n
        index.append(slice(pos * size, (pos + 1) * size))
    return t[tuple(index)]


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward, the identity backward: the
    tensor-parallel ranks each hold the summed value and each carries its
    gradient, as the reference's ``psum`` inside ``shard_map``."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (an all-reduce), with the
    gradient passed through unchanged."""
    return _SumOverGroup.apply(x, group)
