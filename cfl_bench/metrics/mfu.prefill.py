"""The prefill's share of the H100's float32 peak (67 TFLOP/s, TF32 off
as the configuration states): the benchmark's count of each prompt's
forward products and SSD operations (the output head on its last
position only), over the seconds its `try_admit` took."""
from cfl_bench import counts, readers


def read(rec):
    d = rec.data
    if not d["lengths"]:
        return None
    ops = sum(counts.forward_ops(rec.model, 1, n, logits_rows=1)
              for n in d["lengths"])
    return readers.share_of_fp32_peak(ops, sum(d["service_s"]))
