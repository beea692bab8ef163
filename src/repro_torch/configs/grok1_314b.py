"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified] The
port's copy of the reference's config, its training fields included.
``sharding="tp"`` (d_ff tensor-parallel experts in the reference)
is kept as data and has no effect on one device."""
import torch

from repro_torch.configs.lm_common import FULL_ATTN_LONG_SKIP, LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "grok-1-314b"
FAMILY = "lm"
SHAPES = {k: v for k, v in LM_SHAPES.items() if k != "long_500k"}
TRAIN_ACCUM = 16
OPTIMIZER = "adafactor"
ACCUM_DTYPE = "bfloat16"
SKIPS = dict(FULL_ATTN_LONG_SKIP)


def make_config(smoke: bool = False) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
            moe=MoEConfig(n_experts=4, top_k=2, group_size=32,
                          sharding="tp"),
            q_chunk=32, loss_chunks=2, remat_policy="dots")
    return TransformerConfig(
        name=ARCH_ID, n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_head=128, d_ff=32768, vocab=131072,
        moe=MoEConfig(n_experts=8, top_k=2, group_size=256, sharding="tp"),
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        q_chunk=512, loss_chunks=16, remat_policy="nothing",
        remat_block=8)
