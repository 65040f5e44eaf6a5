"""95th percentile of time to first token over every request sent in the
window, ms, from the time each was due to its first token; a request that
failed, was refused or missed the drain deadline counts as infinite."""

import math

from benchlib.common import percentile
from benchlib.serve import failed


def read(run):
    bad = {id(s) for s in failed(run)}
    vals = [math.inf if id(s) in bad or s.req.t_first is None
            else 1e3 * (s.req.t_first - s.due) for s in run.sent]
    return percentile(vals, 95) if vals else None
