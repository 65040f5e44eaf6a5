"""95th percentile (nearest rank) of the wait from submission to admission
(``Request.t_admit - t_submit``), ms, over the window's requests due 4 s or
more before the profiler's start; a request never admitted counts
infinite."""
from benchlib.spans import queue_wait_p95_ms as read
