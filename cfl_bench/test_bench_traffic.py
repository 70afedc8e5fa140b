"""The prefill traffic's prompt lengths, and the idle share read inside
the requests' service spans."""
import numpy as np
import pytest

from cfl_bench import readers, traffic
from cfl_bench.trace import TraceRecord


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_prompt_lengths_are_log_uniform_draws_of_the_seed(seed):
    n = 400
    got = traffic.prompt_lengths(seed, n, 512, 2048)
    assert got.shape == (n,) and got.min() >= 512 and got.max() <= 2048
    assert np.array_equal(got, traffic.prompt_lengths(seed, n, 512, 2048))
    assert not np.array_equal(got, traffic.prompt_lengths(seed + 1, n, 512,
                                                          2048))
    # stratified: the i-th smallest lies in the i-th equal-probability bin
    q = np.log(np.sort(got) / 512) / np.log(4)
    i = np.arange(n)
    assert np.all(q >= (i - 0.6) / n) and np.all(q <= (i + 1.6) / n)
    # a seeded order, not sorted, and many lengths the warm-up never sent
    assert not np.all(np.diff(got) >= 0)
    assert np.unique(got).size > n // 2


def test_idle_share_within_leaves_out_the_time_between_spans():
    # the device busy 0-0.8 and 2.0-2.9 of a 4 s trace; the host served
    # two requests over 0-1 and 2-3: 0.3 s of their 2 s idle
    rec = TraceRecord(window_s=4.0, device=[("k", 0.0, 0.8),
                                            ("k", 2.0, 2.9)], host=[])
    spans = [(0.0, 1.0), (2.0, 3.0)]
    assert rec.busy_within(spans) == pytest.approx(1.7)

    class Rec:
        trace = rec
    assert readers.idle_share_within(Rec, spans) == pytest.approx(15.0)
    assert readers.idle_share(Rec) == pytest.approx(57.5)
    assert readers.idle_share_within(Rec, []) is None
