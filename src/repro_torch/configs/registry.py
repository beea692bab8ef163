"""The architectures the port serves: --arch <id> -> config module. The
dense LMs only; the MoE, recsys and GNN configs wait for their models
(ROADMAP A12)."""
from repro_torch.configs import h2o_danube3_4b, nemotron4_15b, qwen2_72b

ARCHS = {m.ARCH_ID: m for m in (h2o_danube3_4b, qwen2_72b, nemotron4_15b)}


def get(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]
