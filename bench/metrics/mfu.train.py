"""Model FLOPs of a training step (6 N D plus causal attention's forward and
backward) over the median unprofiled step time of the window, at the bf16
peak, %."""
from benchlib.train import mfu_pct as read
