"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 -- GQA with QKV bias. [arXiv:2407.10671; hf] The port's copy
of the reference's config (its training-only fields are not ported)."""
import torch

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "qwen2-72b"


def make_config(smoke: bool = False) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=8,
            n_kv_heads=2, d_head=8, d_ff=128, vocab=512, qkv_bias=True)
    return TransformerConfig(
        name=ARCH_ID, n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_head=128, d_ff=29568, vocab=152064, qkv_bias=True,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
