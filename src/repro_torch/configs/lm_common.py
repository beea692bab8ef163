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

# Pure full-attention archs skip long_500k (sub-quadratic attention needed):
# only h2o-danube3 (SWA) runs it.
FULL_ATTN_LONG_SKIP = {
    "long_500k": ("pure full attention: 500k-context decode exceeds the "
                  "per-chip KV-cache HBM budget and 500k prefill is "
                  "quadratic; run only for the SWA arch (h2o-danube3), "
                  "per assignment note"),
}
