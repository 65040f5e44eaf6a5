"""Paged attention's bound time over its kernel time in the profiled
sub-window, %."""
from benchlib.layers import paged_attn_roofline_pct as read
