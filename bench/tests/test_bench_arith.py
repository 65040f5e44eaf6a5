"""The benchmark's arithmetic on synthetic stamps: tails from due times,
rates over the window, the union of device intervals and its gaps, and the
roofline counts against hand counts."""

import math
import types

import bench_tiny  # noqa: F401  (paths)
import numpy as np
import pytest

from benchlib import common, layers
from benchlib.serve import Sent, ServeRun, Step


class _Req:
    def __init__(self, t_first, t_last, n):
        self.t_first, self.t_last = t_first, t_last
        self.generated = [0] * n
        self.state = "done"

    @property
    def tpot(self):
        return (self.t_last - self.t_first) / (len(self.generated) - 1)


def _run(sent, t0=0.0, t1=10.0, steps=()):
    run = ServeRun("x", {}, {}, 1.0, t0, t1, sent, list(steps),
                   {"prefix_hit_tokens": 0}, {"prefix_hit_tokens": 0}, 0, 0)
    run.perf_t0, run.perf_t1 = t0, t1
    return run


def _sent(i, due, sub, first, last, n):
    s = Sent(due, [1] * 4, n, -1, submitted=sub)
    s.req = _Req(first, last, n)
    s.stamps = list(np.linspace(first, last, n))
    return s


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert common.percentile(xs, 95) == 95
    assert common.percentile([3.0], 95) == 3.0
    assert common.percentile([1, 2, math.inf], 50) == 2
    assert common.percentile([1, 2, math.inf], 95) == math.inf


def test_ttft_counts_from_due_time_through_a_stall():
    """A stall inside the window delays the sends that fall in it; the
    tail still counts each request from when it was due."""
    ttft = common.reader("e2e", "ttft_p95_ms")
    sent = [_sent(i, float(i), float(i), i + 0.1, i + 1.0, 10)
            for i in range(18)]
    # a 3-second stall: requests due at 5.0 and 5.5 were sent at 8.0
    sent.append(_sent(18, 5.0, 8.0, 8.1, 9.0, 10))
    sent.append(_sent(19, 5.5, 8.0, 8.1, 9.0, 10))
    assert ttft(_run(sent)) == pytest.approx(2600.0)
    sent[0].req.state = "failed"
    assert ttft(_run(sent)) == pytest.approx(3100.0)
    sent[1].req.state = "failed"
    assert ttft(_run(sent)) == math.inf


def test_tpot_and_output_rate():
    tpot = common.reader("e2e", "tpot_p95_ms")
    sent = [_sent(i, float(i), float(i), i + 0.1, i + 0.1 + 0.9, 10)
            for i in range(10)]
    assert tpot(_run(sent)) == pytest.approx(100.0)
    sent[3].req.t_last = 3.1 + 9 * 0.5
    assert tpot(_run(sent)) == pytest.approx(500.0)
    assert common.rate(99, 10.0) == pytest.approx(9.9)
    with pytest.raises(ValueError):
        common.rate(1, 0.0)


def test_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert common.union_length(spans) == pytest.approx(3.0)
    assert common.idle_gaps(spans, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert common.spread([1, 2, 3, 4, 5]) == pytest.approx(
        (4.5 - 1.5) / 3)


def test_trace_busy_and_gap_labels():
    from benchlib.trace import Trace, idle_pct
    ev = lambda name, a, b, dev: types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=a, end=b),
        device_type=types.SimpleNamespace(name=dev))
    events = [ev("paged_split_kernel", 0, 400_000, "CUDA"),
              ev("gemm", 600_000, 1_000_000, "CUDA"),
              ev("bench.step", 0, 1_000_000, "CPU"),
              ev("bench.step", 0, 1_000_000, "CUDA"),
              ev("bench.complete", 450_000, 560_000, "CPU")]
    prof = types.SimpleNamespace(events=lambda: events)
    tr = Trace(prof, window_s=1.25)
    assert tr.busy_s == pytest.approx(0.8)
    assert idle_pct(tr) == pytest.approx(36.0)
    assert tr.gaps() == [("complete", pytest.approx(0.2))]
    assert tr.time_of(("paged_",)) == pytest.approx(0.4)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["paged_split_kernel", pytest.approx(0.4)]
    assert dict(b["idle_gaps"]) == {"complete": pytest.approx(0.2),
                                    "window_edges": pytest.approx(0.25)}


def test_paged_attention_counts_by_hand():
    pa = common.roofline("paged_attn")
    # one decode row of context 20 and a 3-token chunk ending at 5, D 4,
    # 2 heads over 1 kv head, pages of 8 tokens
    ops, nbytes = pa.work([1, 3], [20, 5], heads=2, kv_heads=1, head_dim=4,
                          bs=8)
    pairs = 20 + (3 + 4 + 5)
    assert ops == 4 * 4 * 2 * pairs
    pages = 3 + 1
    assert nbytes == (2 * 4 * 2 * 4 * 2 + 2 * pages * 8 * 1 * 4 * 2
                      + 4 * (pages + 4 + 2))
    t = pa.bound_s([1], [16], heads=1, kv_heads=1, head_dim=1, bs=16,
                   peak_ops=1.0, hbm_bps=1e12)
    assert t == pytest.approx(4 * 16)


def test_shared_prefix_pages_count_once():
    """Two rows over one shared 2-page prefix (pages 5 and 6) and a page
    of their own each: the call reads 4 distinct pages, not 6; queries,
    outputs and table slots stay per row."""
    pa = common.roofline("paged_attn")
    step = Step("decode", np.array([1, 1]), np.array([40, 36]))
    step.tables = np.array([[5, 6, 7, 0], [5, 6, 9, 3]], np.int32)
    assert step.kv_pages(16) == 4
    shape = dict(heads=2, kv_heads=1, head_dim=4, bs=16)
    _, shared = pa.work(step.q, step.ctx, kv_pages=4, **shape)
    _, apart = pa.work(step.q, step.ctx, **shape)
    page = 2 * 16 * 1 * 4 * 2  # K and V of one page, bf16
    assert apart - shared == 2 * page
    assert shared == (2 * 2 * 2 * 4 * 2 + 4 * page + 4 * (6 + 2 + 2))
    # a row's table beyond its context is not read: row 2 of context 32
    step.ctx = np.array([40, 32])
    assert step.kv_pages(16) == 3


def test_flash_counts_by_hand():
    fl = common.roofline("flash")
    assert fl.pairs(4) == 10
    assert fl.forward_ops(4, 2, 8) == 4 * 8 * 2 * 10
    assert fl.backward_ops(4, 2, 8) == 10 * 8 * 2 * 10


def test_model_flops_of_a_step():
    arch = dict(bench_tiny.CFG["arch"])
    step = Step("mixed", np.array([1, 5]), np.array([9, 5]))
    d, v = arch["d_model"], arch["vocab_size"]
    # wq, wo: d x d; wk, wv: d x d/2 (2 of 4 heads); three MLP matrices
    per_layer = d * d + d * d // 2 * 2 + d * d + 3 * d * arch["d_ff"]
    att = 4 * 16 * 4 * (9 + (1 + 2 + 3 + 4 + 5))
    want = 2 * 2 * per_layer * 6 + 2 * d * v * 2 + 2 * att
    assert layers.model_flops(arch, 16, step) == want


def test_train_rate_over_completed_steps():
    """Steps completed in the window over the time to the last one's end."""
    run = types.SimpleNamespace(t0=100.0, window_steps=[101.5, 103.0, 104.5],
                                tokens_per_step=16384)
    assert common.reader("e2e", "train_tok_s")(run) == pytest.approx(
        3 * 16384 / 4.5)
    run.window_steps = []
    assert common.reader("e2e", "train_tok_s")(run) is None
