"""Step bundles: (architecture x input shape) -> a training step, its
abstract arguments and its model flops (the training part of the
reference's ``repro/launch/steps.py``).

``build_bundle(arch_id, shape_name, smoke, device)`` returns a
:class:`StepBundle`: the step function, abstract arguments (trees of
``meta`` tensors: shapes and dtypes, no memory), the optimizer's
``init``, per-loop trip counts and the analytic MODEL_FLOPS of the step.
It covers the kinds ``train`` (the LMs), ``recsys_train`` and the GNN's
three (``gnn_full``, ``gnn_minibatch``, ``gnn_batched``); the reference's
other kinds (prefill, decode, serving and retrieval bundles) and its
meshes, partition specs and shardings wait for the launch tooling and
model sharding (ROADMAP A4, A5).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tfm
from repro_torch.train.optimizer import (AdafactorConfig, AdamWConfig,
                                         adafactor_init, adamw_init)
from repro_torch.train.trainstep import make_train_step

__all__ = ["StepBundle", "build_bundle"]


@dataclass
class StepBundle:
    """``fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    (consumes its first two arguments); ``args``: abstract (params,
    opt_state, batch) as ``meta`` tensors; ``opt_init(params)`` makes the
    optimizer state of real parameters; ``config`` the model's config;
    ``device`` where the step runs."""

    name: str
    fn: Callable
    args: Tuple
    opt_init: Callable
    config: Any
    device: torch.device
    trip_counts: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0
    notes: str = ""


def _abstract(init: Callable):
    """The tree ``init()`` would make, as ``meta`` tensors: ``init`` runs
    under a fake-tensor mode on the CPU, so nothing is drawn or held."""
    with FakeTensorMode():
        made = init()
    leaves, treedef = tree.flatten(made)
    return treedef.unflatten([torch.empty(x.shape, dtype=x.dtype,
                                          device="meta") for x in leaves])


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _opt_setup(module, p_abstract, smoke: bool):
    """(abstract state, init, optimizer config, accumulation dtype) of a
    config module: AdamW unless the module names Adafactor (smoke configs
    always AdamW), bf16 accumulation where the module asks for it."""
    name = getattr(module, "OPTIMIZER", "adamw") if not smoke else "adamw"
    accum_dtype = torch.bfloat16 if (
        getattr(module, "ACCUM_DTYPE", "") == "bfloat16" and not smoke) \
        else torch.float32
    if name == "adafactor":
        cfg = AdafactorConfig(lr=1e-2)

        def init(p):
            return adafactor_init(p, cfg)

        return init(p_abstract), init, cfg, accum_dtype
    return adamw_init(p_abstract), adamw_init, AdamWConfig(), accum_dtype


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------


def _lm_active_params(cfg: tfm.TransformerConfig) -> Tuple[float, float]:
    """(active_params, total_params) excluding embeddings, including the
    head."""
    dq, dkv = cfg.qkv_dims
    attn = cfg.d_model * dq * 2 + cfg.d_model * dkv * 2
    n_mats = 3 if cfg.glu else 2
    if cfg.moe is not None:
        router = cfg.d_model * cfg.moe.n_experts
        expert = n_mats * cfg.d_model * cfg.d_ff
        mlp_total = router + cfg.moe.n_experts * expert
        mlp_active = router + cfg.moe.top_k * expert
    else:
        mlp_total = mlp_active = n_mats * cfg.d_model * cfg.d_ff
    head = cfg.d_model * cfg.vocab
    total = cfg.n_layers * (attn + mlp_total) + head
    active = cfg.n_layers * (attn + mlp_active) + head
    return float(active), float(total)


def _lm_attn_flops_train(cfg, batch: int, seq: int) -> float:
    """Attention's two products (q k and p v, 2 flops a multiply-add) over
    the causal (or windowed) pairs, forward and backward (3x)."""
    kv_avg = seq / 2 if cfg.swa_window is None else min(cfg.swa_window, seq)
    return 3.0 * 2 * 2 * batch * seq * kv_avg * cfg.n_heads * cfg.d_head


def _lm_bundle(module, shape_name: str, smoke: bool, dev) -> StepBundle:
    cfg = module.make_config(smoke)
    shape = dict(module.SHAPES[shape_name])
    if shape["kind"] != "train":
        raise NotImplementedError(
            f"{module.ARCH_ID}:{shape_name} is a {shape['kind']!r} bundle; "
            "the port's bundles are the training kinds (prefill and decode "
            "serve through repro_torch.serve.decode; the bundles wait for "
            "the launch tooling, ROADMAP A5)")
    if smoke:
        shape["seq"] = min(shape["seq"], 64)
        shape["batch"] = min(shape["batch"], 4)
    b, s = shape["batch"], shape["seq"]
    active, _ = _lm_active_params(cfg)
    p_abstract = tfm.blocked_view(
        _abstract(lambda: tfm.init(cfg, device="cpu")), cfg)
    opt_abstract, opt_init, opt_cfg, accum_dtype = _opt_setup(
        module, p_abstract, smoke)
    accum = 1 if smoke else getattr(module, "TRAIN_ACCUM", 1)
    step = make_train_step(lambda p, bt: tfm.train_loss(p, bt, cfg),
                           opt_cfg, accum_steps=accum,
                           accum_dtype=accum_dtype)
    return StepBundle(
        name=f"{module.ARCH_ID}:{shape_name}", fn=step,
        args=(p_abstract, opt_abstract,
              {"tokens": _meta((b, s)), "labels": _meta((b, s))}),
        opt_init=opt_init, config=cfg, device=dev,
        trip_counts={"layers": cfg.n_layers, "loss_chunks": cfg.loss_chunks,
                     "q_chunks": max(1, s // cfg.q_chunk)},
        model_flops=6.0 * active * b * s + _lm_attn_flops_train(cfg, b, s))


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------


def _gnn_bundle(module, shape_name: str, smoke: bool, dev) -> StepBundle:
    """The reference's GNN bundle, its smoke caps (n_nodes and n_edges <=
    512, batch_nodes <= 64, batch <= 8, d_feat <= 32), AdamW lr 1e-2 and
    model flops. One batch leaf differs: the reference's ``rng`` key
    becomes the sampling draws ``rand1 (B, f1)`` and ``rand2 (B, f1, f2)``
    (``models/gnn.py``). The reference pads the edges to a multiple of the
    data axes; on one device that is no padding, and it is left out."""
    shape = dict(module.SHAPES[shape_name])
    if smoke:
        for k_ in ("n_nodes", "n_edges"):
            if k_ in shape:
                shape[k_] = min(shape[k_], 512)
        shape["batch_nodes"] = min(shape.get("batch_nodes", 64), 64)
        shape["batch"] = min(shape.get("batch", 8), 8)
        shape["d_feat"] = min(shape["d_feat"], 32)
    f, c = shape["d_feat"], shape["n_classes"]
    cfg = module.make_config(smoke=False, d_feat=f, n_classes=c)
    kind = shape["kind"]
    p_abstract = _abstract(lambda: gnn.init(cfg, device="cpu"))
    h = cfg.d_hidden
    if kind == "gnn_full":
        n, e = shape["n_nodes"], shape["n_edges"]
        batch = {"feats": _meta((n, f), torch.float32),
                 "edges": _meta((2, e)), "labels": _meta((n,)),
                 "mask": _meta((n,), torch.float32)}
        loss_fn = gnn.full_graph_loss
        flops = 3.0 * (2 * n * f * h + 2 * n * h * c + 2 * e * (h + c))
    elif kind == "gnn_minibatch":
        n, e, bn = shape["n_nodes"], shape["n_edges"], shape["batch_nodes"]
        f1, f2 = cfg.fanouts
        batch = {"feats": _meta((n, f), torch.float32),
                 "indptr": _meta((n + 1,)), "indices": _meta((e,)),
                 "seeds": _meta((bn,)), "labels": _meta((bn,)),
                 "rand1": _meta((bn, f1)), "rand2": _meta((bn, f1, f2))}
        loss_fn = gnn.minibatch_loss
        flops = 3.0 * 2 * bn * (f1 * f2 + 2 * f1 + 2) * f * h
    else:  # gnn_batched (molecule)
        g_, nn_, ee = shape["batch"], shape["n_nodes"], shape["n_edges"]
        batch = {"feats": _meta((g_, nn_, f), torch.float32),
                 "edges": _meta((g_, ee, 2)), "labels": _meta((g_,))}
        loss_fn = gnn.batched_graphs_loss
        flops = 3.0 * 2 * g_ * (nn_ * f * h + nn_ * h * c + ee * h)
    step = make_train_step(lambda p, bt: loss_fn(p, bt, cfg),
                           AdamWConfig(lr=1e-2))
    return StepBundle(
        name=f"{module.ARCH_ID}:{shape_name}", fn=step,
        args=(p_abstract, adamw_init(p_abstract), batch),
        opt_init=adamw_init, config=cfg, device=dev, model_flops=flops)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

_RECSYS_MODELS = {"dlrm": recsys.dlrm, "fm": recsys.fm, "bst": recsys.bst,
                  "mind": recsys.mind}


def _mlp_flops(dims) -> float:
    return float(sum(2 * a * b_ for a, b_ in zip(dims[:-1], dims[1:])))


def _recsys_batch(model_name: str, cfg, b: int):
    if model_name == "dlrm":
        return {"dense": _meta((b, cfg.n_dense), torch.float32),
                "sparse": _meta((b, cfg.n_sparse)), "label": _meta((b,))}
    if model_name == "fm":
        return {"sparse": _meta((b, cfg.n_sparse)), "label": _meta((b,))}
    if model_name == "bst":
        return {"seq": _meta((b, cfg.seq_len)), "target": _meta((b,)),
                "label": _meta((b,))}
    return {"seq": _meta((b, cfg.seq_len)), "target": _meta((b,))}


def _recsys_flops(model_name: str, cfg, b: int) -> float:
    """Forward and backward (3x) flops of a training step's batch."""
    if model_name == "dlrm":
        d = cfg.embed_dim
        f = cfg.n_sparse + 1
        return 3.0 * b * (_mlp_flops((cfg.n_dense,) + cfg.bot_mlp)
                          + 2 * f * f * d
                          + _mlp_flops((f * (f - 1) // 2 + cfg.bot_mlp[-1],)
                                       + cfg.top_mlp))
    if model_name == "fm":
        return 3.0 * b * (2 * cfg.n_sparse * cfg.embed_dim)
    if model_name == "bst":
        d, s = cfg.embed_dim, cfg.seq_len + 1
        blk = 4 * 2 * s * d * d + 2 * 2 * s * s * d \
            + 2 * s * d * cfg.ff_dim * 2
        return 3.0 * b * (cfg.n_blocks * blk
                          + _mlp_flops((s * d,) + cfg.mlp))
    d, s, k_ = cfg.embed_dim, cfg.seq_len, cfg.n_interests
    return 3.0 * b * cfg.capsule_iters * (2 * 2 * s * k_ * d + 2 * d * d)


def _recsys_bundle(module, shape_name: str, smoke: bool,
                   dev) -> StepBundle:
    model_name = module.MODEL
    model = _RECSYS_MODELS[model_name]
    cfg = module.make_config(smoke)
    shape = dict(module.SHAPES[shape_name])
    if shape["kind"] != "recsys_train":
        raise NotImplementedError(
            f"{module.ARCH_ID}:{shape_name} is a {shape['kind']!r} bundle; "
            "the port's bundles are the training kinds (recsys serving and "
            "retrieval run through repro_torch.serve.retrieval; the bundles "
            "wait for the launch tooling, ROADMAP A5)")
    if smoke:
        shape["batch"] = min(shape["batch"], 32)
    b = shape["batch"]
    p_abstract = _abstract(lambda: model.init(torch.Generator(), cfg,
                                              device="cpu"))
    step = make_train_step(lambda p, bt: model.ctr_loss(p, bt, cfg),
                           AdamWConfig(lr=1e-3))
    return StepBundle(
        name=f"{module.ARCH_ID}:{shape_name}", fn=step,
        args=(p_abstract, adamw_init(p_abstract),
              _recsys_batch(model_name, cfg, b)),
        opt_init=adamw_init, config=cfg, device=dev,
        model_flops=_recsys_flops(model_name, cfg, b))


def build_bundle(arch_id: str, shape_name: str, smoke: bool = False,
                 device=None) -> StepBundle:
    """The training step of ``arch_id`` at ``shape_name`` (``smoke``: the
    reduced config, seq <= 64 and batch <= 4, recsys batch <= 32, the
    GNN's caps of :func:`_gnn_bundle`), to run on ``device`` (the GPU
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    module = registry.get(arch_id)
    if module.FAMILY == "lm":
        return _lm_bundle(module, shape_name, smoke, dev)
    if module.FAMILY == "recsys":
        return _recsys_bundle(module, shape_name, smoke, dev)
    if module.FAMILY == "gnn":
        return _gnn_bundle(module, shape_name, smoke, dev)
    raise NotImplementedError(
        f"{arch_id} ({module.FAMILY}) has no step bundle in the port yet: "
        "the launch tooling's other bundles are ROADMAP A5")
