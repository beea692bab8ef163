"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 -- GQA with QKV bias. [arXiv:2407.10671; hf] The port's copy
of the reference's config, its training fields included (Adafactor,
gradient accumulation over 8 microbatches, hierarchical remat in blocks of
10 layers)."""
import torch

from repro_torch.configs.lm_common import FULL_ATTN_LONG_SKIP, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "qwen2-72b"
FAMILY = "lm"
SHAPES = {k: v for k, v in LM_SHAPES.items() if k != "long_500k"}
TRAIN_ACCUM = 8
OPTIMIZER = "adafactor"
SKIPS = dict(FULL_ATTN_LONG_SKIP)


def make_config(smoke: bool = False) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=8,
            n_kv_heads=2, d_head=8, d_ff=128, vocab=512, qkv_bias=True,
            q_chunk=32, loss_chunks=2, remat_policy="dots")
    return TransformerConfig(
        name=ARCH_ID, n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_head=128, d_ff=29568, vocab=152064, qkv_bias=True,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        q_chunk=512, loss_chunks=16, remat_policy="nothing",
        remat_block=10)
