"""Images whose outputs are back in host memory over the whole window (host clock)."""


def read(run):
    r = run.records
    return r["images"] / r["window_s"] if r["window_s"] > 0 else None
