"""Step bundles: (architecture x input shape) -> a step, its abstract
arguments, its partition specs and its model flops (port of the
reference's ``repro/launch/steps.py``).

``build_bundle(arch_id, shape_name, smoke, device, mesh)`` returns a
:class:`StepBundle` for every (arch, shape) cell of the registry: the step
function, abstract arguments (trees of ``meta`` tensors: shapes and
dtypes, no memory), the in/out partition specs of the reference's
``in_shardings`` / ``out_shardings`` under ``mesh`` (the host mesh by
default; any :class:`repro_torch.launch.mesh.Mesh`, the production meshes
included, for specs), per-loop trip counts and the analytic MODEL_FLOPS.
Kinds: ``train`` (the LMs), ``prefill`` and ``decode`` (the LMs' flat
layer layout), ``recsys_train``, ``recsys_serve``, ``recsys_retrieval``,
the GNN's three (``gnn_full``, ``gnn_minibatch``, ``gnn_batched``), and
the paper's ``vs_learn`` (one Algorithm 5 data pass) and ``vs_search`` /
``vs_search_sorted`` (Algorithm 1 with eager GleanVec scoring through the
``gleanvec_sq_topk`` kernel, a full-precision rerank and the top k).

Where the reference leaves placement to XLA, the steps run on one device
unless ``mesh`` has more than one position and a ``torch.distributed``
process group of that many ranks is live (``launch/mesh.device_mesh``,
made at the step's first call). Then the explicit collectives run as the
reference's ``shard_map``s do: DLRM's 2D lookup
(``embedding.make_sharded_lookup``, when the mesh has a "model" axis and
the config is not smoke), the ``vs_search`` merge (each rank scans its
rows, lifts its ids by its shard's offset, one all-gather and a stable
top k), the ``vs_learn`` moments (each rank's partial sums and moments
all-reduced before the fit) and the LM steps, prefill, decode and
training (``transformer.prefill_step`` / ``decode_step`` /
``train_loss`` under ``trainstep.make_train_step``, with the mesh's
``partitioned.Groups``: tensor-, expert- and data-parallel under the
specs, fsdp weights gathered a layer at a time and their gradients
reduce-scattered, the optimizer on its shards, on a mesh of more than one
position). Each rank then passes its own blocks of the arguments
(``sharding.local_block`` under ``in_specs``) and gets its blocks of
``out_specs``. A training batch is laid out by ``trainstep.rank_major``
first, so that each data rank's block holds its block of every
microbatch and the mesh's microbatch i is the one-process step's.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core import gleanvec as gv_mod
from repro_torch.core import linalg, spherical_kmeans
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import embedding as emb_mod
from repro_torch.models import gnn, partitioned, recsys
from repro_torch.models import transformer as tfm
from repro_torch.models.sharding import P, MeshRules, logical_to_spec
from repro_torch.train.optimizer import (AdafactorConfig, AdafactorState,
                                         AdamWConfig, AdamWState,
                                         adafactor_init, adamw_init)
from repro_torch.train.trainstep import make_train_step

__all__ = ["StepBundle", "build_bundle", "recsys_serve_fn", "retrieval_fn",
           "vs_candidates", "vs_rerank"]


@dataclass
class StepBundle:
    """``fn`` the step; ``args`` its abstract arguments as ``meta``
    tensors; ``in_specs`` / ``out_specs`` the partition specs of its
    arguments and results (the reference's ``in_shardings`` /
    ``out_shardings``); ``config`` the model's config; ``device`` where the
    step runs. Training kinds: ``fn(params, opt_state, batch) -> (params,
    opt_state, metrics)`` (consumes its first two arguments) and
    ``opt_init(params)`` makes the optimizer state of real parameters."""

    name: str
    fn: Callable
    args: Tuple
    config: Any
    device: torch.device
    in_specs: Tuple = ()
    out_specs: Any = None
    opt_init: Optional[Callable] = None
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


def _axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _pad_up(n: int, mult: int) -> int:
    return -(-n // max(mult, 1)) * max(mult, 1)


def _all_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)


def _live_group(mesh, axes, dev):
    """``get()`` -> the process group of ``axes`` on ``mesh``'s live
    ``DeviceMesh`` (made at the first call; raises without a group of
    ``mesh.size`` ranks)."""
    return functools.cache(lambda: mesh_mod.axis_group(
        mesh_mod.device_mesh(mesh, dev.type), axes))


def _lm_groups(mesh, rules: MeshRules, dev):
    """``get()`` -> the process groups (``partitioned.Groups``) of the LM
    steps under ``rules`` on ``mesh``'s live ``DeviceMesh``, made
    at the first call; ``partitioned.NO_GROUPS`` on a one-position
    mesh."""
    def get():
        if mesh.size == 1:
            return partitioned.NO_GROUPS
        return partitioned.groups_on(mesh, rules, dev.type)

    return functools.cache(get)


def _zip_specs(fn, specs, shapes):
    """``fn(spec, shape)`` over a spec tree and the abstract tree it
    describes (dicts and lists; a spec is a leaf)."""
    if isinstance(specs, dict):
        return {k: _zip_specs(fn, specs[k], shapes[k]) for k in specs}
    if isinstance(specs, list):
        return [_zip_specs(fn, s, x) for s, x in zip(specs, shapes)]
    return fn(specs, shapes)


def _replicated_specs(abstract):
    leaves, treedef = tree.flatten(abstract)
    return treedef.unflatten([P() for _ in leaves])


def _opt_specs(p_specs) -> AdamWState:
    return AdamWState(step=P(), mu=p_specs, nu=p_specs)


def _adafactor_specs(p_specs, p_abstract, momentum: bool) -> AdafactorState:
    """Factored moments drop a dim of their parameter's spec: the row
    moment the last, the column moment the second to last."""
    def full(spec, p):
        t = tuple(spec)
        return t + (None,) * (p.ndim - len(t))

    def vr(spec, p):
        t = full(spec, p)
        return P(*t[:-1]) if p.ndim >= 2 else P(*t)

    def vc(spec, p):
        t = full(spec, p)
        return P(*(t[:-2] + t[-1:])) if p.ndim >= 2 else P(None)

    return AdafactorState(
        step=P(), vr=_zip_specs(vr, p_specs, p_abstract),
        vc=_zip_specs(vc, p_specs, p_abstract),
        mu=_zip_specs(lambda s, p: s if momentum else P(None), p_specs,
                      p_abstract))


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


def _opt_state_specs(opt_cfg, p_specs, p_abstract):
    """The optimizer state's specs: AdamW's moments those of their
    parameters, Adafactor's factored (``_adafactor_specs``)."""
    if isinstance(opt_cfg, AdafactorConfig):
        return _adafactor_specs(p_specs, p_abstract,
                                opt_cfg.momentum is not None)
    return _opt_specs(p_specs)


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


def _lm_bundle(module, shape_name: str, mesh, rules: MeshRules, smoke: bool,
               dev) -> StepBundle:
    cfg = module.make_config(smoke)
    shape = dict(module.SHAPES[shape_name])
    if smoke:
        shape["seq"] = min(shape["seq"], 64)
        shape["batch"] = min(shape["batch"], 4)
    b, s = shape["batch"], shape["seq"]
    kind = shape["kind"]
    name = f"{module.ARCH_ID}:{shape_name}"
    active, _ = _lm_active_params(cfg)

    if kind == "train":
        p_abstract = tfm.blocked_view(
            _abstract(lambda: tfm.init(cfg, device="cpu")), cfg)
        p_specs = tfm.param_specs(cfg, rules)
        opt_abstract, opt_init, opt_cfg, accum_dtype = _opt_setup(
            module, p_abstract, smoke)
        o_specs = _opt_state_specs(opt_cfg, p_specs, p_abstract)
        accum = 1 if smoke else getattr(module, "TRAIN_ACCUM", 1)
        # the microbatch stays divisible by the data-parallel degree
        dp_size = max(_axes_size(mesh, rules.dp), 1)
        while accum > 1 and (b // accum) % dp_size != 0:
            accum //= 2
        groups = _lm_groups(mesh, rules, dev)

        @functools.cache
        def step():
            g = groups()
            return make_train_step(
                lambda p, bt: tfm.train_loss(p, bt, cfg, g, p_specs),
                opt_cfg, accum_steps=accum, accum_dtype=accum_dtype,
                groups=g, specs=p_specs)

        b_specs = {"tokens": rules.batch(None),
                   "labels": rules.batch(None)}
        return StepBundle(
            name=name, fn=lambda p, o, bt: step()(p, o, bt),
            args=(p_abstract, opt_abstract,
                  {"tokens": _meta((b, s)), "labels": _meta((b, s))}),
            config=cfg, device=dev, opt_init=opt_init,
            in_specs=(p_specs, o_specs, b_specs),
            out_specs=(p_specs, o_specs, P()),
            trip_counts={"layers": cfg.n_layers,
                         "loss_chunks": cfg.loss_chunks,
                         "q_chunks": max(1, s // cfg.q_chunk)},
            model_flops=6.0 * active * b * s
            + _lm_attn_flops_train(cfg, b, s))

    # serving takes the flat layer layout (the blocked one is training's)
    cfg = dataclasses.replace(cfg, remat_block=0)
    p_abstract = _abstract(lambda: tfm.init(cfg, device="cpu"))
    if kind == "prefill":
        p_specs = tfm.param_specs(cfg, rules)
        groups = _lm_groups(mesh, rules, dev)
        return StepBundle(
            name=name,
            fn=lambda p, t: tfm.prefill_step(p, t, cfg, groups(), p_specs),
            args=(p_abstract, _meta((b, s))), config=cfg, device=dev,
            in_specs=(p_specs, rules.batch(None)),
            out_specs=(logical_to_spec(rules, ("batch", "vocab")),
                       tfm.cache_specs(cfg, rules)),
            trip_counts={"layers": cfg.n_layers,
                         "q_chunks": max(1, s // cfg.q_chunk)},
            model_flops=2.0 * active * b * s
            + _lm_attn_flops_train(cfg, b, s) / 3.0)

    # decode: one new token against a seq-long cache, written in place and
    # returned (the reference returns a new cache); the batch is sharded
    # only where it divides the data-parallel degree
    dp_size = _axes_size(mesh, rules.dp)
    decode_rules = MeshRules(
        dp=rules.dp if b % max(dp_size, 1) == 0 else (),
        fsdp=(rules.fsdp if cfg.moe is not None else ()), tp=rules.tp,
        ep=rules.ep)
    c_specs = tfm.cache_specs(cfg, decode_rules)
    kv_len = tfm.cache_len(cfg, s)
    p_specs = tfm.param_specs(cfg, decode_rules)
    groups = _lm_groups(mesh, decode_rules, dev)
    return StepBundle(
        name=name,
        fn=lambda p, c, t, q: tfm.decode_step(p, c, t, q, cfg, groups(),
                                              p_specs),
        args=(p_abstract,
              _abstract(lambda: tfm.init_cache(cfg, b, s, device="cpu")),
              _meta((b,)), _meta(())),
        config=cfg, device=dev,
        in_specs=(p_specs, c_specs,
                  decode_rules.batch(), P()),
        out_specs=(logical_to_spec(decode_rules, ("batch", "vocab")),
                   c_specs),
        trip_counts={"layers": cfg.n_layers},
        model_flops=2.0 * active * b
        + 2 * 2 * b * kv_len * cfg.n_heads * cfg.d_head,
        notes="serve_step (decode)")


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------


def _gnn_bundle(module, shape_name: str, mesh, rules: MeshRules,
                smoke: bool, dev) -> StepBundle:
    """The reference's GNN bundle, its smoke caps (n_nodes and n_edges <=
    512, batch_nodes <= 64, batch <= 8, d_feat <= 32), AdamW lr 1e-2, its
    specs (the full graph's edges over the data axes, padded to their
    size) and model flops. One batch leaf differs: the reference's ``rng``
    key becomes the sampling draws ``rand1 (B, f1)`` and ``rand2 (B, f1,
    f2)`` (``models/gnn.py``), each over the data axes as the seeds."""
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
    p_specs = _replicated_specs(p_abstract)
    h = cfg.d_hidden
    if kind == "gnn_full":
        n = shape["n_nodes"]
        e = _pad_up(shape["n_edges"], _axes_size(mesh, rules.dp))
        batch = {"feats": _meta((n, f), torch.float32),
                 "edges": _meta((2, e)), "labels": _meta((n,)),
                 "mask": _meta((n,), torch.float32)}
        b_specs = {"feats": P(), "edges": P(None, rules.dp or None),
                   "labels": P(), "mask": P()}
        loss_fn = gnn.full_graph_loss
        flops = 3.0 * (2 * n * f * h + 2 * n * h * c + 2 * e * (h + c))
    elif kind == "gnn_minibatch":
        n, e, bn = shape["n_nodes"], shape["n_edges"], shape["batch_nodes"]
        f1, f2 = cfg.fanouts
        batch = {"feats": _meta((n, f), torch.float32),
                 "indptr": _meta((n + 1,)), "indices": _meta((e,)),
                 "seeds": _meta((bn,)), "labels": _meta((bn,)),
                 "rand1": _meta((bn, f1)), "rand2": _meta((bn, f1, f2))}
        b_specs = {"feats": P(), "indptr": P(), "indices": P(),
                   "seeds": rules.batch(), "labels": rules.batch(),
                   "rand1": rules.batch(None),
                   "rand2": rules.batch(None, None)}
        loss_fn = gnn.minibatch_loss
        flops = 3.0 * 2 * bn * (f1 * f2 + 2 * f1 + 2) * f * h
    else:  # gnn_batched (molecule)
        g_, nn_, ee = shape["batch"], shape["n_nodes"], shape["n_edges"]
        batch = {"feats": _meta((g_, nn_, f), torch.float32),
                 "edges": _meta((g_, ee, 2)), "labels": _meta((g_,))}
        b_specs = {"feats": rules.batch(None, None),
                   "edges": rules.batch(None, None),
                   "labels": rules.batch()}
        loss_fn = gnn.batched_graphs_loss
        flops = 3.0 * 2 * g_ * (nn_ * f * h + nn_ * h * c + ee * h)
    step = make_train_step(lambda p, bt: loss_fn(p, bt, cfg),
                           AdamWConfig(lr=1e-2))
    o_specs = _opt_specs(p_specs)
    return StepBundle(
        name=f"{module.ARCH_ID}:{shape_name}", fn=step,
        args=(p_abstract, adamw_init(p_abstract), batch), config=cfg,
        device=dev, opt_init=adamw_init,
        in_specs=(p_specs, o_specs, b_specs),
        out_specs=(p_specs, o_specs, P()), model_flops=flops)


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


def _recsys_param_specs(model_name: str, p_abstract, rules: MeshRules):
    """DLRM's table rows over tp and its dim over dp; the item tables and
    FM's per-id leaves rows over tp; the rest replicated (matched by leaf
    path, as the reference's ``keystr``)."""
    tp, dp = rules.tp, rules.dp if rules.dp else None
    paths, leaves, treedef = tree.flatten_with_paths(p_abstract)

    def spec_for(path, leaf):
        if "table" in path and model_name == "dlrm":
            return P(tp, dp)
        if "item_emb" in path or "'v'" in path or ("'w'" in path
                                                   and leaf.ndim == 1):
            return P(tp) if leaf.ndim == 1 else P(tp, None)
        return P()

    return treedef.unflatten([spec_for(p, x) for p, x in zip(paths, leaves)])


def recsys_serve_fn(model_name: str, cfg, lookup_fn=None):
    """``serve(params, batch)``: the (B,) logits (scores) of a recommender
    on a batch of its ``train_batch`` form (labels ignored). DLRM looks
    its packed ids up with ``lookup_fn`` where given."""
    model = _RECSYS_MODELS[model_name]
    if model_name == "dlrm":
        def serve(p, bt):
            return model.logits(p, bt, cfg, lookup_fn)
    elif model_name == "mind":
        def serve(p, bt):
            caps = model.interests(p, bt["seq"], cfg)
            t_emb = p["item_emb"][bt["target"].long()].to(torch.float32)
            return model.score_against(caps, t_emb, cfg.pow_p)
    elif model_name == "fm":
        def serve(p, bt):
            return model.logits(p, bt["sparse"], cfg)
    else:
        def serve(p, bt):
            return model.logits(p, bt, cfg)
    return serve


def retrieval_fn(model_name: str, cfg):
    """``retrieval(params, batch, candidates (N, d)) -> ids (B, 10)``
    int32: the user tower's vectors against every candidate, the top 10
    (the baseline full-D retrieval; GleanVec's is ``serve/retrieval.py``)."""
    model = _RECSYS_MODELS[model_name]

    def retrieval(p, bt, candidates):
        user = model.user_embedding(p, bt, cfg)              # (B, d)
        scores = user @ candidates.T                         # (B, N)
        return torch.topk(scores, 10, dim=1).indices.to(torch.int32)

    return retrieval


def _recsys_bundle(module, shape_name: str, mesh, rules: MeshRules,
                   smoke: bool, dev) -> StepBundle:
    model_name = module.MODEL
    model = _RECSYS_MODELS[model_name]
    cfg = module.make_config(smoke)
    shape = dict(module.SHAPES[shape_name])
    if smoke:
        shape["batch"] = min(shape["batch"], 32)
        shape["n_candidates"] = min(shape.get("n_candidates", 4096), 4096)
    b, kind = shape["batch"], shape["kind"]
    name = f"{module.ARCH_ID}:{shape_name}"
    p_abstract = _abstract(lambda: model.init(torch.Generator(), cfg,
                                              device="cpu"))
    p_specs = _recsys_param_specs(model_name, p_abstract, rules)
    batch = _recsys_batch(model_name, cfg, b)
    b_specs = {k_: rules.batch(*([None] * (v.ndim - 1)))
               for k_, v in batch.items()}
    flops = _recsys_flops(model_name, cfg, b)

    lookup_fn = None
    if model_name == "dlrm" and rules.tp is not None and not smoke:
        live = functools.cache(lambda: emb_mod.make_sharded_lookup(
            mesh_mod.device_mesh(mesh, dev.type), cfg.padded_total_vocab,
            cfg.embed_dim))

        def lookup_fn(table, idx):
            return live()(table, idx)

    if kind == "recsys_train":
        if model_name == "dlrm":
            def loss_fn(p, bt):
                return model.ctr_loss(p, bt, cfg, lookup_fn=lookup_fn)
        else:
            def loss_fn(p, bt):
                return model.ctr_loss(p, bt, cfg)
        o_specs = _opt_specs(p_specs)
        return StepBundle(
            name=name, fn=make_train_step(loss_fn, AdamWConfig(lr=1e-3)),
            args=(p_abstract, adamw_init(p_abstract), batch), config=cfg,
            device=dev, opt_init=adamw_init,
            in_specs=(p_specs, o_specs, b_specs),
            out_specs=(p_specs, o_specs, P()), model_flops=flops)

    if kind == "recsys_serve":
        return StepBundle(
            name=name, fn=recsys_serve_fn(model_name, cfg, lookup_fn),
            args=(p_abstract, batch), config=cfg, device=dev,
            in_specs=(p_specs, b_specs), out_specs=rules.batch(),
            model_flops=flops / 3.0)

    # recsys_retrieval: users vs n_candidates item vectors (the paper's
    # MIPS), the candidates padded to a multiple of every mesh axis
    all_axes = _all_axes(mesh)
    n_cand = _pad_up(shape["n_candidates"], _axes_size(mesh, all_axes))
    user_dim = cfg.bot_mlp[-1] if model_name == "dlrm" else cfg.embed_dim
    if b % max(_axes_size(mesh, rules.dp), 1) != 0:
        b_specs = {k_: P(*([None] * v.ndim)) for k_, v in batch.items()}
    return StepBundle(
        name=name, fn=retrieval_fn(model_name, cfg),
        args=(p_abstract, batch, _meta((n_cand, user_dim), torch.float32)),
        config=cfg, device=dev,
        in_specs=(p_specs, b_specs, P(all_axes or None, None)),
        out_specs=P(),
        model_flops=flops / 3.0 + 2.0 * b * n_cand * user_dim,
        notes="baseline full-D retrieval; GleanVec variant in serve/")


# ---------------------------------------------------------------------------
# Vector-search family (the paper's own workload)
# ---------------------------------------------------------------------------

# rows of the sorted layout's blocks (one tag a block), and the unit the
# database is padded to on every shard
VS_BLOCK = 4096
NEG_SCORE = -3.4e38


def vs_candidates(q_views, tags, x_low, kappa: int, sorted_layout: bool):
    """The reduced scan's top ``kappa``: (vals, ids) (B, kappa), ids rows
    of ``x_low`` (-1 past its rows). ``gleanvec_sq_topk`` over the
    gathered layout (``tags (n,)``) or the sorted one (``tags`` a tag per
    ``n / len(tags)``-row block)."""
    from repro_torch.index import bruteforce
    search = (bruteforce.search_gleanvec_sorted if sorted_layout
              else bruteforce.search_gleanvec)
    return search(q_views, tags, x_low, kappa, device=x_low.device)


def vs_rerank(q, ids, x_full):
    """Full-precision scores of the candidates ``ids (B, kappa)``
    against ``q (B, D)``; ``NEG_SCORE`` where an id is -1."""
    cand = x_full[ids.clamp(min=0).long()]                  # (B, kappa, D)
    full = torch.bmm(cand, q[:, :, None])[..., 0]
    return torch.where(ids >= 0, full, torch.full_like(full, NEG_SCORE))


def _vs_learn_step(c: int, d_low: int, groups):
    """One Algorithm 5 data pass: the assignment (``kmeans_assign``), the
    new centers, the query moment, the per-cluster moments (C products of
    each cluster's rows, not the reference's C masked products of all
    rows: the same sums) and the fits. ``groups()`` gives (the rows'
    group, the queries' group) to all-reduce the partial sums over, or
    None on one device."""
    import torch.distributed as dist

    def learn_step(x, q, centers):
        x = x.to(torch.float32)
        x_unit = spherical_kmeans.normalize_rows(x)
        tags = spherical_kmeans.assign(x_unit, centers.contiguous())
        sums = torch.zeros((c, x.shape[1]), dtype=torch.float32,
                           device=x.device).index_add_(0, tags.long(), x_unit)
        k_q = linalg.second_moment(q)
        k_x_c = gv_mod.per_cluster_moments(x, tags, c)
        live = groups()
        if live is not None:
            rows_group, q_group = live
            dist.all_reduce(sums, group=rows_group)
            dist.all_reduce(k_x_c, group=rows_group)
            if q_group is not None:
                dist.all_reduce(k_q, group=q_group)
        new_centers = spherical_kmeans.normalize_rows(sums)
        model = gv_mod.fit_from_moments(new_centers, k_q, k_x_c, d_low)
        return new_centers, model.a, model.b

    return learn_step


def _vs_search_step(kappa: int, k: int, sorted_layout: bool, group):
    """Algorithm 1 with eager GleanVec scoring: the views A_c q, the
    reduced scan's top kappa, the full-precision rerank, the top k (a
    stable sort: equal values keep the earlier candidate, as
    ``jax.lax.top_k``). ``group()`` is the shards' process group (None on
    one device): each rank scans its rows, lifts its ids by its shard's
    offset, and one all-gather of the candidates makes the global top k."""
    from repro_torch.index.distributed import _gathered_merge, _merge_topk

    def search_step(q, tags, x_low, x_full, a_mats):
        q_views = torch.einsum("cdk,mk->mcd", a_mats, q)      # (B, C, d)
        _, ids = vs_candidates(q_views, tags, x_low, kappa, sorted_layout)
        full = vs_rerank(q, ids, x_full)
        g = group()
        if g is None:
            return _merge_topk(full, ids, k)
        import torch.distributed as dist
        offset = dist.get_rank(g) * x_low.shape[0]
        gids = torch.where(ids >= 0, ids + offset, torch.full_like(ids, -1))
        return _gathered_merge(full, gids, g, k)

    return search_step


def _vs_bundle(module, shape_name: str, mesh, rules: MeshRules, smoke: bool,
               dev) -> StepBundle:
    shape = dict(module.SHAPES[shape_name])
    all_axes = _all_axes(mesh)
    n_shards = _axes_size(mesh, all_axes)
    if smoke:
        shape["n"] = min(shape["n"], 2048)
        shape["m_queries"] = min(shape.get("m_queries", 256), 256)
        shape["batch"] = min(shape.get("batch", 32), 32)
    dim, d_low, c = shape["D"], shape["d"], shape["C"]
    rows_spec = P(all_axes or None, None)
    name = f"{module.ARCH_ID}:{shape_name}"
    cfg = module.make_config(smoke)
    live = n_shards > 1
    rows_group = _live_group(mesh, all_axes, dev) if live else lambda: None

    if shape["kind"] == "vs_learn":
        n = _pad_up(min(shape["n"], 1_000_000), n_shards * 512)
        m = _pad_up(shape["m_queries"], n_shards)
        q_group = _live_group(mesh, rules.dp, dev) if live and rules.dp \
            else (lambda: None)
        groups = (lambda: (rows_group(), q_group())) if live \
            else (lambda: None)
        flops = (2.0 * n * c * dim            # assignment
                 + 2.0 * m * dim * dim        # K_Q
                 + 2.0 * c * n * dim * dim    # per-cluster moments
                 + 2.0 * n * dim)             # masks / normalize
        return StepBundle(
            name=name, fn=_vs_learn_step(c, d_low, groups),
            args=(_meta((n, dim), torch.float32),
                  _meta((m, dim), torch.float32),
                  _meta((c, dim), torch.float32)),
            config=cfg, device=dev,
            in_specs=(rows_spec, rules.batch(None), P()),
            out_specs=(P(), P(), P()), trip_counts={"clusters": c},
            model_flops=flops,
            notes="Algorithm 5 data pass (train_step analogue)")

    sorted_layout = shape["kind"] == "vs_search_sorted"
    n = _pad_up(shape["n"], n_shards * VS_BLOCK)
    b, k_, kappa = shape["batch"], shape["k"], shape["kappa"]
    flops = (2.0 * b * c * d_low * dim        # eager views
             + 2.0 * b * n * d_low            # reduced scan
             + 2.0 * b * kappa * n_shards * dim)  # rerank
    return StepBundle(
        name=name, fn=_vs_search_step(kappa, k_, sorted_layout, rows_group),
        args=(_meta((b, dim), torch.float32),
              _meta((n // VS_BLOCK,) if sorted_layout else (n,)),
              _meta((n, d_low), torch.float32),
              _meta((n, dim), torch.float32),
              _meta((c, d_low, dim), torch.float32)),
        config=cfg, device=dev,
        in_specs=(P(), P(all_axes or None), rows_spec, rows_spec, P()),
        out_specs=(P(), P()),
        trip_counts={"db_blocks": n // n_shards // VS_BLOCK},
        model_flops=flops,
        notes="Algorithm 1 multi-step search (serve_step analogue)")


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

_FAMILIES = {"lm": _lm_bundle, "gnn": _gnn_bundle, "recsys": _recsys_bundle,
             "vectorsearch": _vs_bundle}


def build_bundle(arch_id: str, shape_name: str, smoke: bool = False,
                 device=None, mesh: Optional[mesh_mod.Mesh] = None
                 ) -> StepBundle:
    """The step of ``arch_id`` at ``shape_name`` (``smoke``: the reduced
    config and the reference's caps: seq <= 64 and batch <= 4 for the LMs,
    batch <= 32 and candidates <= 4096 for the recommenders, the GNN's of
    :func:`_gnn_bundle`, n <= 2048, queries <= 256 and batch <= 32 for
    the vector search), its specs under ``mesh`` (default
    ``make_host_mesh()``), to run on ``device`` (the GPU unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    module = registry.get(arch_id)
    if shape_name in getattr(module, "SKIPS", {}):
        raise ValueError(
            f"{arch_id}:{shape_name} skipped: {module.SKIPS[shape_name]}")
    if module.FAMILY not in _FAMILIES:
        raise ValueError(f"unknown family {module.FAMILY}")
    mesh = mesh_mod.make_host_mesh() if mesh is None else mesh
    return _FAMILIES[module.FAMILY](module, shape_name, mesh,
                                    MeshRules.for_mesh(mesh), smoke, dev)
