"""``correct`` comes out true for the program as it is and false for its
control and for each fault the serving cells can have, planted in the
timed path underneath a run that otherwise goes as the benchmark's own
(the look for a card skipped, the tiny configuration on the CPU)."""

import bench_tiny
import pytest
import torch

from benchlib import serve

SEEDS = (1, 2, 3)


@pytest.fixture(scope="module")
def sound_runs():
    return {seed: bench_tiny.serve_run(seed) for seed in SEEDS}


def _correct(run, seed):
    return serve.is_correct(serve.checks(run, seed, bench_tiny.CFG))


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(sound_runs, seed):
    run = sound_runs[seed]
    c = serve.checks(run, seed, bench_tiny.CFG)
    assert serve.is_correct(c), c
    assert c["sampled_tokens"][0] >= bench_tiny.CFG["serve"]["check"]["tokens"]


@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_control_fails(sound_runs, seed):
    """The reference in float8 in the program's place: the gap of the
    tokens it puts first exceeds the limit."""
    run = sound_runs[seed]
    picked = serve.sample(run, seed, bench_tiny.CFG["serve"]["check"]["tokens"])
    gaps = serve.served_gaps(run.arch, run.params, picked,
                             bench_tiny.CFG["norm_eps"], quant="fp8")
    assert max(gaps) > bench_tiny.TINY_MAX_GAP


def _altered_token(monkeypatch):
    from repro_torch.serve import engine
    real = engine.ServeEngine._sample

    def sample(self, step, shard, args):
        ids = real(self, step, shard, args).clone()
        ids[0] = (ids[0] + 1) % self.cfg.vocab_size
        return ids
    monkeypatch.setattr(engine.ServeEngine, "_sample", sample)


def _state_unchanged(monkeypatch):
    from repro_torch.serve import paged_model

    def write_nothing(pools, l, blk, off, k_rows, v_rows, dest=None):
        return pools["k"][l], pools["v"][l], None, None
    monkeypatch.setattr(paged_model, "_write_kv", write_nothing)


def _half_batch_left_out(monkeypatch):
    """The step's second half of live rows gets no answer of its own: each
    takes the first row's token."""
    from repro_torch.serve import engine
    real = engine.ServeEngine._run_step

    def half(self, plan, step, arrays, b):
        ids = real(self, plan, step, arrays, b).copy()
        ids[(b + 1) // 2:] = ids[0]
        return ids
    monkeypatch.setattr(engine.ServeEngine, "_run_step", half)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_batch_left_out],
                         ids=["token_altered", "state_unchanged",
                              "half_batch_left_out"])
def test_fault_fails(monkeypatch, fault):
    fault(monkeypatch)
    run = bench_tiny.serve_run(4)
    assert not _correct(run, 4)
