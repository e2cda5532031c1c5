"""95th percentile of every request of the window, due to answered (host clock, ms); a failed or unanswered request counts as infinite."""

from port_bench.readers import percentile


def read(run):
    return percentile(run.records["latency_s"], 95) * 1e3
