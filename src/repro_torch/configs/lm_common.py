"""Shared shape set of the LM architectures (the port's copy of the
reference's ``repro/configs/lm_common.py``)."""
from __future__ import annotations

# kind: "train" is a training step; "prefill" the forward pass over the
# prompt; "decode" one new token against a seq_len KV cache.
LM_SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}
