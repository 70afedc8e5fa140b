"""The probe's backbone pass against the H100's float32 peak (67 TFLOP/s,
TF32 off as the configuration states): the benchmark's count of the
forward products of every layer over all sequences (no output head: the
features are the last hidden states), over the port's own span of the
pass (`coded_head_probe.run`'s "features" seconds, ending in a sync;
experiments the profiler traced are left out)."""
from cfl_bench import counts, readers


def read(rec):
    d = rec.data
    if not d["backbone_s"]:
        return None
    ops = counts.forward_ops(rec.model, d["rows"], d["seq_len"],
                             logits_rows=0)
    return readers.share_of_fp32_peak(ops * len(d["backbone_s"]),
                                      sum(d["backbone_s"]))
