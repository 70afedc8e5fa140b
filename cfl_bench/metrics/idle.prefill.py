"""Percent of the traced requests' service time (each `try_admit`, from
the host's call to its token on the host) in which no operation ran on
the device: the host's share of serving a request.  The open loop's wait
for arrivals, between requests, is left out.  The requests' host spans
are placed on the device's timeline from the first traced request's start
at the first device operation, which its token copy starts within some
microseconds of."""
from cfl_bench import readers


def read(rec):
    return readers.idle_share_within(rec, rec.data.get("traced_spans"))
