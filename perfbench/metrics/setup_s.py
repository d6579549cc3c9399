"""Set-up: process start to the first timed request (the harness's own clock)."""


def read(run):
    return run.setup_s
