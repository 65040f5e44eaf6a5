"""Tokens of every training step completed in the window over the time
from the window's start to the end of its last step, tokens/s."""

from benchlib.common import rate


def read(run):
    if not run.window_steps:
        return None
    return rate(run.tokens_per_step * len(run.window_steps),
                run.window_steps[-1] - run.t0)
