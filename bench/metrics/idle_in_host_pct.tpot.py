"""Device-idle time of the profiled sub-window whose middle lies in a span
of the program other than its waits (the innermost span there exists and
is neither ``engine.wait`` nor ``worker.park``), over the sub-window's
length, %."""
from benchlib.spans import idle_in_host_pct as read
