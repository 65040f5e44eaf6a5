"""Prompt tokens served from the prefix cache over prompt tokens sent, %."""
from benchlib.layers import prefix_hit_share_pct as read
