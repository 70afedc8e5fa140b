"""Host milliseconds a round of the port's `fed.trainer.round_weights`
(the arrivals' draw and the 1/p weights), from the harness's span."""


def read(rec):
    n = rec.spans.count("round_weights")
    return 1e3 * rec.spans.total("round_weights") / n if n else None
