"""Harness time per step in the pool's cleanup (WFE reclamation), ms."""
from benchlib.layers import cleanup_ms_per_step as read
