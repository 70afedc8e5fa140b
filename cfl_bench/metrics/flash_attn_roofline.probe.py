"""Kernel 8 (`kernels/flash_attn`: `flash_attn_kernel`,
`short_attn_kernel`) against its roofline over the traced experiments:
the sum of its least times (one launch a layer, each the larger of its
bytes over 3.35 TB/s and its operations on the 3xTF32 route over 495
TFLOP/s) over the sum of its device time in the trace."""
from cfl_bench import counts, readers


def read(rec):
    m, d = rec.model, rec.data
    if m["arch_type"] != "dense" or not d["traced_experiments"]:
        return None
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    one = counts.attention_kernel_terms(d["rows"], m["n_heads"],
                                        m["n_kv_heads"], d["seq_len"], hd)
    least = d["traced_experiments"] * m["n_layers"] * one["least_s"]
    return readers.roofline_share(rec, ("flash_attn_kernel",
                                        "short_attn_kernel"), least)
