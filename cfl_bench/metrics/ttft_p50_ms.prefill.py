"""The median time to first token of the window's requests (those the
profiler traced left out): a steadier companion of ttft_p95_ms."""
import statistics


def read(rec):
    ttft = rec.data["ttft_s"]
    return 1e3 * statistics.median(ttft) if ttft else None
