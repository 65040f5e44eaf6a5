"""Mean time of the window's decode steps from dispatch to sampled ids on
the host (the program's ``engine.step`` less ``Scheduler.complete``), ms,
from the scheduler's ``decode_ns`` and ``decode_dispatches``; none under
20 steps."""
from benchlib.spans import decode_step_ms as read
