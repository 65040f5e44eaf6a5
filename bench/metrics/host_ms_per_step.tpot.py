"""Harness host time per step in Scheduler.tick and Scheduler.complete
(engine and scheduler), ms, over the window's unprofiled steps."""
from benchlib.layers import host_ms_per_step as read
