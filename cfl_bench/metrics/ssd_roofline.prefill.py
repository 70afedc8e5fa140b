"""Kernel 7 (`kernels/ssd`, `ssd_chunk_kernel`) against its roofline over
the traced requests: the sum of its least times (one launch a Mamba2
layer a prompt, each the larger of its bytes over 3.35 TB/s and its
operations on the 3xTF32 route over 495 TFLOP/s, counted unpadded) over
the sum of its device time in the trace."""
from cfl_bench import counts, readers


def read(rec):
    m = rec.model
    if m["arch_type"] != "ssm":
        return None
    s = m["ssm"]
    heads = s["expand"] * m["d_model"] // s["headdim"]
    least = sum(m["n_layers"] * counts.ssd_kernel_terms(
        n, s["chunk"], heads, s["headdim"], s["d_state"],
        s["n_groups"])["least_s"] for n in rec.data["traced_lengths"])
    return readers.roofline_share(rec, ("ssd_chunk_kernel",), least)
