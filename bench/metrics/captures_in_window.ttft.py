"""Step signatures first dispatched (eager, then captured) inside the window."""
from benchlib.layers import captures_in_window as read
