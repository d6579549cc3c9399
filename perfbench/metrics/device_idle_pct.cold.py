"""Device: the share of the sampled slices of the served loop in which no
device op ran (100 minus the union of device activity over the slices'
length), from torch.profiler. Moves propose_s."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0 or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
