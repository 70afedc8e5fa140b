"""The Mamba2 family's parameter tree (arXiv:2405.21060): an embedding,
`n_layers` stacked [RMSNorm + Mamba2 mixer] blocks, a final RMSNorm and
an output head (the embedding's transpose where the model ties them).

Each leaf is (path, shape, init): init ("normal", std), ("ones",),
("zeros",) or ("log_linspace", lo, hi), the initialisers the Mamba2
reference code uses (N(0, 1)/sqrt(fan_in) projections, a_log =
log(linspace(1, 16, H)), unit D and norm scales, zero dt bias)."""
from __future__ import annotations

import math


def dims(model: dict) -> dict:
    s, d = model["ssm"], model["d_model"]
    heads = s["expand"] * d // s["headdim"]
    inner = heads * s["headdim"]
    return {"heads": heads, "inner": inner,
            "conv_dim": inner + 2 * s["n_groups"] * s["d_state"],
            "in_width": 2 * inner + 2 * s["n_groups"] * s["d_state"] + heads}


def leaves(model: dict) -> list[tuple[str, tuple, tuple]]:
    d, v, n = model["d_model"], model["vocab"], model["n_layers"]
    s, k = model["ssm"], dims(model)
    out = [("embed", (v, d), ("normal", 0.02)),
           ("final_norm/scale", (d,), ("ones",))]
    if not model.get("tie_embeddings", False):
        out.append(("lm_head", (d, v), ("normal", 1 / math.sqrt(d))))
    mix = "blocks/mixer/"
    out += [
        ("blocks/norm/scale", (n, d), ("ones",)),
        (mix + "w_in", (n, d, k["in_width"]), ("normal", 1 / math.sqrt(d))),
        (mix + "conv_w", (n, s["d_conv"], k["conv_dim"]), ("normal", 0.1)),
        (mix + "conv_b", (n, k["conv_dim"]), ("zeros",)),
        (mix + "a_log", (n, k["heads"]), ("log_linspace", 1.0, 16.0)),
        (mix + "dt_bias", (n, k["heads"]), ("zeros",)),
        (mix + "d_skip", (n, k["heads"]), ("ones",)),
        (mix + "norm_scale", (n, k["inner"]), ("ones",)),
        (mix + "w_out", (n, k["inner"], d),
         ("normal", 1 / math.sqrt(k["inner"]))),
    ]
    return out
