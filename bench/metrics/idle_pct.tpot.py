"""One minus the union of device intervals over the profiled sub-window, %."""
from benchlib.layers import idle as read
