"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1. The modality frontend
(early fusion) is out of scope for the LM backbone.
[hf:meta-llama/Llama-4; unverified] The port's copy of the reference's
config, its training fields included, kept as the reference
has it: every layer is an MoE layer and there is no shared expert, where
the published model also has a shared expert and interleaves dense
layers. ``sharding="ep"`` (experts over the model axis in the reference)
is kept as data and has no effect on one device."""
import torch

from repro_torch.configs.lm_common import FULL_ATTN_LONG_SKIP, LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "llama4-maverick-400b-a17b"
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
            moe=MoEConfig(n_experts=8, top_k=1, group_size=32,
                          sharding="ep"),
            q_chunk=32, loss_chunks=2, remat_policy="dots")
    return TransformerConfig(
        name=ARCH_ID, n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_head=128, d_ff=8192, vocab=202048,
        moe=MoEConfig(n_experts=128, top_k=1, group_size=1024,
                      sharding="ep"),
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        q_chunk=512, loss_chunks=16, remat_policy="nothing",
        remat_block=8)
