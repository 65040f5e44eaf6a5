"""The profiled training steps' wait for the next batch (the program's
``train.data`` spans) per step, ms."""
from benchlib.spans import data_wait_ms_per_step as read
