"""Carrying fitted models and encoded scorers across from the reference.

The reference's models and scorers are NamedTuples of arrays. Their
fields, as a dict of numpy arrays keyed by field name (``arrays_of``),
build the port's objects on a given device -- so a test can fit or encode
once in the reference and serve the very same weights and codes here.
A streaming store's ``live`` mask comes across as a bool tensor.
``ivf_index`` carries a reference IVF index across (a frozen dataclass:
its arrays, its center companion by class, and its static ``nprobe`` and
``aligned_layout``); ``graph_index`` a reference graph index (its three
arrays and five static fields); ``streaming_state`` a reference
``StreamingState`` (moments, model, ``prev_bw`` and counters).
``transformer_params`` carries an LM's parameter tree across (numpy
leaves, bf16 ones exactly; a blocked layer layout flattened to (L, ...)),
``recsys_params`` a recommender's (nested dicts and lists, one tensor a
leaf), ``gnn_params`` a GCN's (``{"w": [{"w", "b"}, ...]}``) and
``linear_dr`` a linear baseline (``{a, b}``). ``adamw_state``
and ``adafactor_state`` carry an optimizer state across (its step and its
moment trees, every leaf in its own type and shape), so a run can start
in the port from the reference's state mid-run.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import scorer as sc
from repro_torch.core.baselines import LinearDR
from repro_torch.core.gleanvec import GleanVecModel
from repro_torch.core.leanvec_sphering import SpheringModel
from repro_torch.device import resolve_device

__all__ = ["arrays_of", "sphering_model", "gleanvec_model", "linear_dr",
           "scorer", "ivf_index", "graph_index", "streaming_state",
           "transformer_params", "recsys_params", "gnn_params",
           "adamw_state", "adafactor_state", "SCORERS"]

SCORERS = {cls.__name__: cls for cls in (
    sc.LinearScorer, sc.GleanVecScorer, sc.QuantizedScorer,
    sc.GleanVecQuantizedScorer, sc.SortedGleanVecScorer,
    sc.SortedGleanVecQuantizedScorer)}

# field -> dtype; every other field is float32, and ``codes`` keeps uint8
# (the f32 pseudo-codes of a reduced-probe center companion stay f32)
_DTYPES = {"tags": torch.int32, "block_tags": torch.int32,
           "perm": torch.int32, "inv_perm": torch.int32,
           "list_block_ranges": torch.int32, "lists": torch.int32,
           "live": torch.bool, "neighbors": torch.int32,
           "entries": torch.int32, "nbr_rows": torch.int32}


def arrays_of(obj) -> dict:
    """``{field: numpy array}`` of a NamedTuple of arrays (None fields
    left out). Works on any array type numpy can convert."""
    return {f: np.asarray(getattr(obj, f)) for f in obj._fields
            if getattr(obj, f) is not None}


def _tensor(name, value, device):
    value = np.array(value, order="C")     # a writable copy
    dtype = torch.uint8 if value.dtype == np.uint8 and name == "codes" \
        else _DTYPES.get(name, torch.float32)
    return torch.as_tensor(value, dtype=dtype, device=device)


def _build(cls, arrays: dict, device):
    dev = resolve_device(device)
    kw = {f: _tensor(f, arrays[f], dev) for f in cls._fields if f in arrays}
    missing = [f for f in cls._fields
               if f not in kw and f not in cls._field_defaults]
    if missing:
        raise ValueError(f"{cls.__name__} needs fields {missing}")
    return cls(**kw)


def sphering_model(arrays: dict, device=None) -> SpheringModel:
    """A LeanVec-Sphering model from ``{a, b, p, w, w_pinv}``."""
    return _build(SpheringModel, arrays, device)


def gleanvec_model(arrays: dict, device=None) -> GleanVecModel:
    """A GleanVec model from ``{centers, a, b, w, w_pinv}``."""
    return _build(GleanVecModel, arrays, device)


def linear_dr(arrays: dict, device=None) -> LinearDR:
    """A linear baseline (``core.baselines.LinearDR``) from ``{a, b}``."""
    return _build(LinearDR, arrays, device)


def scorer(kind: str, arrays: dict, device=None):
    """One of the six scorer classes, named as in the reference
    (``"SortedGleanVecQuantizedScorer"``, ...), from its field arrays."""
    if kind not in SCORERS:
        raise ValueError(f"unknown scorer class {kind!r}; one of "
                         f"{sorted(SCORERS)}")
    return _build(SCORERS[kind], arrays, device)


def ivf_index(index, device=None):
    """The port's :class:`~repro_torch.index.ivf.IVFIndex` from a reference
    ``IVFIndex``: ``centers``, ``lists``, the optional ``center_scorer``
    (rebuilt by class name), ``nprobe`` and ``aligned_layout``."""
    from repro_torch.index.ivf import IVFIndex
    dev = resolve_device(device)
    cs = index.center_scorer
    return IVFIndex(
        centers=_tensor("centers", index.centers, dev),
        lists=_tensor("lists", index.lists, dev),
        center_scorer=None if cs is None
        else scorer(type(cs).__name__, arrays_of(cs), dev),
        nprobe=int(index.nprobe), aligned_layout=bool(index.aligned_layout))


def graph_index(index, device=None):
    """The port's :class:`~repro_torch.index.graph.GraphIndex` from a
    reference ``GraphIndex``: ``neighbors``, ``entries`` and ``nbr_rows``
    (None on a graph that is not fused), and the static ``beam``,
    ``max_hops``, ``expand``, ``fused`` and ``scan_tn``."""
    from repro_torch.index.graph import GraphIndex
    dev = resolve_device(device)
    nbr_rows = index.nbr_rows
    return GraphIndex(
        neighbors=_tensor("neighbors", index.neighbors, dev),
        entries=_tensor("entries", index.entries, dev),
        nbr_rows=None if nbr_rows is None
        else _tensor("nbr_rows", nbr_rows, dev),
        beam=int(index.beam), max_hops=int(index.max_hops),
        expand=int(index.expand), fused=bool(index.fused),
        scan_tn=int(index.scan_tn))


def streaming_state(state, device=None):
    """The port's :class:`~repro_torch.core.streaming.StreamingState`
    from a reference one: its moments, its model (LeanVec-Sphering or
    GleanVec, by class name), ``prev_bw`` and the two counters."""
    from repro_torch.core.streaming import StreamingState
    dev = resolve_device(device)
    build = gleanvec_model if type(state.model).__name__ == "GleanVecModel" \
        else sphering_model
    return StreamingState(
        k_q=_tensor("k_q", state.k_q, dev), k_x=_tensor("k_x", state.k_x, dev),
        model=build(arrays_of(state.model), dev),
        prev_bw=_tensor("prev_bw", state.prev_bw, dev),
        updates_since=int(np.asarray(state.updates_since)),
        refresh_every=int(state.refresh_every))


def _leaf(value, device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same type. numpy holds JAX's bf16 as
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses: its bits
    cross as int16 and are viewed as bf16, so every value is kept."""
    value = np.array(value, order="C")     # a writable copy
    if value.dtype.name == "bfloat16":
        return torch.from_numpy(value.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(value).to(device)


def transformer_params(params, cfg, device=None):
    """The reference's transformer parameter tree (nested dicts, leaves
    convertible to numpy) -> the port's dict of tensors on ``device``, for
    ``repro_torch.models.transformer``, nested subtrees included (an MoE
    layer's ``"moe"``: router and experts). Stacked layer leaves in the
    blocked layout (n_blocks, block, ...) are flattened to (L, ...), as the
    reference does for serving: an expert leaf (n_blocks, block, E, D, F)
    arrives as (L, E, D, F)."""
    dev = resolve_device(device)
    # wq is (L, D, dq) flat and (n_blocks, block, D, dq) blocked
    blocked = np.ndim(params["layers"]["wq"]) == 4

    def convert(tree, stacked):
        if isinstance(tree, dict):
            return {k: convert(v, stacked) for k, v in tree.items()}
        t = _leaf(tree, dev)
        if stacked and blocked:
            if t.ndim < 2 or t.shape[0] * t.shape[1] != cfg.n_layers:
                raise ValueError(f"a blocked layer leaf of shape "
                                 f"{tuple(t.shape)} does not hold "
                                 f"{cfg.n_layers} layers")
            t = t.reshape((cfg.n_layers,) + tuple(t.shape[2:]))
        return t

    return {k: convert(v, k == "layers") for k, v in params.items()}


def recsys_params(params, cfg, device=None):
    """A recommender's parameter tree from the reference (``dlrm``, ``fm``,
    ``bst`` or ``mind`` of ``repro.models.recsys``: nested dicts, lists of
    MLP layers and of BST blocks, leaves convertible to numpy) -> the same
    tree of tensors in ``cfg.param_dtype`` on ``device``, for
    ``repro_torch.models.recsys``."""
    dev = resolve_device(device)

    def convert(tree):
        if isinstance(tree, dict):
            return {k: convert(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [convert(v) for v in tree]
        return _leaf(tree, dev).to(cfg.param_dtype)

    return convert(params)


def gnn_params(params, device=None):
    """A GCN's parameter tree from the reference (``repro.models.gnn``'s
    ``{"w": [{"w", "b"}, ...]}``, leaves convertible to numpy) -> the same
    tree of tensors, each leaf in its own type, on ``device``."""
    return _state_tree(params, resolve_device(device))


def _state_tree(tree, dev):
    if isinstance(tree, dict):
        return {k: _state_tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_state_tree(v, dev) for v in tree]
    return _leaf(tree, dev)


def _step(step, dev) -> torch.Tensor:
    return torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev)


def adamw_state(state, device=None):
    """The reference's ``AdamWState`` (``step``, ``mu``, ``nu``; leaves
    convertible to numpy) -> the port's on ``device``, each moment leaf in
    the reference's shape: pair it with parameters in the same layout
    (``transformer.blocked_view`` for a blocked config)."""
    from repro_torch.train.optimizer import AdamWState
    dev = resolve_device(device)
    return AdamWState(step=_step(state.step, dev),
                      mu=_state_tree(state.mu, dev),
                      nu=_state_tree(state.nu, dev))


def adafactor_state(state, device=None):
    """The reference's ``AdafactorState`` (``step``, ``vr``, ``vc``,
    ``mu``) -> the port's on ``device`` (the momentum in its own type,
    bf16 bits kept), shapes as the reference's."""
    from repro_torch.train.optimizer import AdafactorState
    dev = resolve_device(device)
    return AdafactorState(step=_step(state.step, dev),
                          vr=_state_tree(state.vr, dev),
                          vc=_state_tree(state.vc, dev),
                          mu=_state_tree(state.mu, dev))
