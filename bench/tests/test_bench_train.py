"""The training driver on the tiny configuration: ``correct`` true for the
program as it is, false for the float8 control and for the faults a
one-card training step can have, planted underneath the timed step."""

import bench_tiny
import pytest
import torch

from benchlib import common, reference, train, weights


@pytest.fixture(scope="module")
def sound():
    return bench_tiny.train_run(1, seconds=2.0)


def test_sound_run_is_correct(sound):
    c = train.checks(sound, 1, bench_tiny.TRAIN_CFG)
    assert train.is_correct(c), c
    assert len(sound.losses) >= 4


def test_fp8_control_fails(sound):
    cfg = bench_tiny.TRAIN_CFG
    arch, tr = cfg["arch"], cfg["train"]
    gen = common.generator(bench_tiny.TRAIN_MIX["kind"])
    p0 = weights.make_params(arch, 1, torch.device("cpu"), dtype=torch.float32)
    batches = [gen.batch_at(bench_tiny.TRAIN_MIX, 1, k, arch["vocab_size"])
               for k in range(3)]
    ref = reference.train_steps(arch, p0, batches, tr["adamw"],
                                eps=cfg["norm_eps"],
                                microbatches=tr["microbatches"])
    low = reference.train_steps(arch, p0, batches, tr["adamw"],
                                eps=cfg["norm_eps"],
                                microbatches=tr["microbatches"], quant="fp8")
    gaps = train.compare(low, ref)
    lim = tr["check"]
    assert any(gaps[k] > lim[k] for k in ("loss_gap", "grad_gap",
                                          "change_gap")), gaps


def _state_unchanged(monkeypatch):
    from repro_torch.train import trainer

    def no_update(cfg, params, grads, state):
        return params, state, {"lr": torch.zeros(()),
                               "grad_norm": torch.zeros(())}
    monkeypatch.setattr(trainer, "adamw_update", no_update)


def _half_batch_left_out(monkeypatch):
    """The second half of the microbatches repeats the first: the step's
    mean is taken over half of the batch."""
    from repro_torch.train import trainer
    real = trainer._split_microbatches

    def half(batch, n):
        mbs = real(batch, n)
        return mbs[:n // 2] * 2
    monkeypatch.setattr(trainer, "_split_microbatches", half)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch_left_out],
                         ids=["state_unchanged", "half_batch_left_out"])
def test_fault_fails(monkeypatch, fault):
    fault(monkeypatch)
    run = bench_tiny.train_run(2)
    assert not train.is_correct(train.checks(run, 2, bench_tiny.TRAIN_CFG))
