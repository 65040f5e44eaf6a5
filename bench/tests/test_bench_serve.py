"""The serving driver on the tiny configuration: the warm-up reaches every
step signature the mix dispatches, and a mix behind shared system prompts
is served from the prefix cache the set-up filled."""

import bench_tiny
import pytest

from benchlib import common, serve


@pytest.mark.parametrize("mix", ["unshared", "shared"])
def test_no_capture_in_window(mix):
    run = bench_tiny.serve_run(
        7, mix=bench_tiny.SHARED if mix == "shared" else None)
    assert run.captures_after == run.captures_before, run.new_shapes
    assert serve.is_correct(serve.checks(run, 7, bench_tiny.CFG))
    share = common.reader("metrics", "prefix_hit_share.ttft")(run)
    if mix == "shared":
        assert share is not None and share > 50.0
    else:
        assert share is None


def test_signatures_of_a_mix():
    space = [{"prompt": (30, 40), "output": (2, 2), "cached": (0,)}]
    sigs = serve.signatures(space, bs=16, chunk=32)
    # prompts 30-32 fit one chunk (bucket 32); 33-40 take a chunk of 32 and
    # a last one of 1-8 tokens; widths pow2(ceil((p + 2) / 16)): 2 for
    # p = 30, else 4
    assert sigs["w_hi"] == 4
    assert sigs["prefill"] == [(2, 32), (4, 1), (4, 2), (4, 4), (4, 8),
                               (4, 32)]
    assert sigs["buckets"] == [1, 2, 4, 8, 16, 32]
