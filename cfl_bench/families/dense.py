"""The dense decoder family's parameter tree (Llama-style: RMSNorm,
grouped-query attention with rope, SwiGLU MLP, an output head that is
the embedding's transpose where the model ties them)."""
from __future__ import annotations

import math


def head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def leaves(model: dict) -> list[tuple[str, tuple, tuple]]:
    d, v, n, ff = (model["d_model"], model["vocab"], model["n_layers"],
                   model["d_ff"])
    q_w = model["n_heads"] * head_dim(model)
    kv_w = model["n_kv_heads"] * head_dim(model)
    out = [("embed", (v, d), ("normal", 0.02)),
           ("final_norm/scale", (d,), ("ones",))]
    if not model.get("tie_embeddings", False):
        out.append(("lm_head", (d, v), ("normal", 1 / math.sqrt(d))))
    out += [
        ("blocks/attn_norm/scale", (n, d), ("ones",)),
        ("blocks/attn/wq", (n, d, q_w), ("normal", 1 / math.sqrt(d))),
        ("blocks/attn/wk", (n, d, kv_w), ("normal", 1 / math.sqrt(d))),
        ("blocks/attn/wv", (n, d, kv_w), ("normal", 1 / math.sqrt(d))),
        ("blocks/attn/wo", (n, q_w, d), ("normal", 1 / math.sqrt(q_w))),
        ("blocks/mlp_norm/scale", (n, d), ("ones",)),
        ("blocks/mlp/w_gate", (n, d, ff), ("normal", 1 / math.sqrt(d))),
        ("blocks/mlp/w_up", (n, d, ff), ("normal", 1 / math.sqrt(d))),
        ("blocks/mlp/w_down", (n, ff, d), ("normal", 1 / math.sqrt(ff))),
    ]
    return out
