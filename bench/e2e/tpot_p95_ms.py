"""95th percentile over every request sent in the window of its time per
output token, (t_last - t_first) / (n - 1), ms; a request that failed
counts as infinite."""

import math

from benchlib.common import percentile
from benchlib.serve import failed


def read(run):
    bad = {id(s) for s in failed(run)}
    vals = []
    for s in run.sent:
        r = s.req
        if id(s) in bad or r is None or r.tpot is None:
            vals.append(math.inf)
        else:
            vals.append(1e3 * r.tpot)
    return percentile(vals, 95) if vals else None
