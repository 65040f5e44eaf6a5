"""The flash kernels' bound time (operations at the bf16 peak; forward,
remat recompute and backward launches of the profiled steps) over their
device time, %."""
from benchlib.train import flash_roofline_pct as read
