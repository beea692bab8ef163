"""The architectures the port serves: --arch <id> -> config module. The
dense and MoE LMs, the four recommenders, the GCN and the paper's own
vector-search workload."""
from repro_torch.configs import (bst, dlrm_mlperf, fm, gcn_cora,
                                 gleanvec_paper, grok1_314b, h2o_danube3_4b,
                                 llama4_maverick, mind, nemotron4_15b,
                                 qwen2_72b)

ARCHS = {m.ARCH_ID: m for m in (h2o_danube3_4b, qwen2_72b, nemotron4_15b,
                                grok1_314b, llama4_maverick, bst, mind,
                                dlrm_mlperf, fm, gcn_cora, gleanvec_paper)}


def get(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]
