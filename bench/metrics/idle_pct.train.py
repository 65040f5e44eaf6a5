"""One minus the union of device intervals over the profiled steps, %."""
from benchlib.layers import idle as read
