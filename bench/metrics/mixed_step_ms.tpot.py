"""Mean time of the window's mixed steps from dispatch to sampled ids on
the host (the program's ``engine.step`` less ``Scheduler.complete``), ms,
from the scheduler's ``mixed_ns`` and ``mixed_dispatches``; none under 20
steps."""
from benchlib.spans import mixed_step_ms as read
