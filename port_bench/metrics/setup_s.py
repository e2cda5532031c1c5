"""Set-up: process start to the first timed request or step (host clock, s)."""


def read(run):
    return run.setup_s
