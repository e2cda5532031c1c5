"""Requests answered over the whole window, from its start until the last
answer is back (host clock): the offered load is above what the server
sustains, so the backlog left at the close counts, with the time it takes."""

import numpy as np


def read(run):
    r = run.records
    answered = int(np.isfinite(r["latency_s"]).sum())
    return answered / r["window_s"] if answered and r["window_s"] > 0 else None
