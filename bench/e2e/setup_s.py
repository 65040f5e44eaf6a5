"""Process start to window start, s: weights, pools, kernel build or load,
the warm-up's captures."""


def read(run):
    return run.setup_s
