"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 -- llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified] The port's copy of the reference's config
(its training-only fields are not ported)."""
import torch

from repro_torch.models.transformer import TransformerConfig

ARCH_ID = "h2o-danube-3-4b"


def make_config(smoke: bool = False) -> TransformerConfig:
    if smoke:
        return TransformerConfig(
            name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_head=16, d_ff=128, vocab=256, swa_window=16)
    return TransformerConfig(
        name=ARCH_ID, n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
        d_head=120, d_ff=10240, vocab=32000, swa_window=4096,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
