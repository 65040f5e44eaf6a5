"""Query tokens of live rows over the tokens the padded steps computed
(the scheduler's ``tokens_live`` and ``tokens_computed``), between the
stats snapshots at the window's start and after its drain, %."""
from benchlib.spans import useful_token_pct as read
