"""Seconds of both CFL heads an experiment (the plan, the parity encode
and both 300-epoch runs), from the port's own span (`coded_head_probe.
run`'s "heads" seconds, ending in a sync); experiments the profiler
traced are left out."""


def read(rec):
    heads = rec.data["heads_s"]
    return sum(heads) / len(heads) if heads else None
