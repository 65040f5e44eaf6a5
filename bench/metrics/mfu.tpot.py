"""Model FLOPs of the window's steps over their summed time from dispatch
to sampled ids, at the bf16 peak, %."""
from benchlib.layers import mfu_pct as read
