"""95th percentile (nearest rank) of the wait from admission to the first
prefill chunk planned for the request (``Request.t_prefill - t_admit``),
ms, over the window's requests due 4 s or more before the profiler's
start; a request never reached counts infinite."""
from benchlib.spans import prefill_wait_p95_ms as read
