"""The federated training step's share of the H100's float32 peak (67
TFLOP/s, TF32 off as the configuration states): the benchmark's count of
a round's products and SSD operations, forward and backward, times the
rounds of the window, over their host seconds (rounds the profiler
traced are left out)."""
from cfl_bench import counts, readers


def read(rec):
    d = rec.data
    if not d.get("rounds"):
        return None
    ops = d["rounds"] * counts.train_ops(rec.model, d["batch"], d["seq"])
    return readers.share_of_fp32_peak(ops, d["seconds"])
