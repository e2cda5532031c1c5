"""Mean images per batch of the micro-batcher over the window (its own counters)."""


def read(run):
    r = run.records
    return r["batched_images"] / r["batches"] if r["batches"] else None
