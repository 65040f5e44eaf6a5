"""The trainer's compiled step held against ``repro``'s
``jax.jit(make_train_step(...))`` (``Trainer._step_fn``) on the CPU.

On the card ``Trainer`` captures one CUDA graph per step signature and
replays it; a graph needs every input's shape to follow from the
signature, no host sync anywhere in the step (forward, backward and
AdamW), and the launches autograd's device thread makes for the capture
counted with it.  These tests check what makes that so, with weights
carried over from ``repro`` by ``from_jax_params(master=True)``:

(a) ``trainer._step_fn._cache_size()`` equals the reference ``Trainer``'s
    after the same batches: smoke stablelm-3b at 1 and 2 microbatches over
    three (batch, seq) shapes with repeats, and whisper-small with its
    frames; the losses match within 1e-4 relative;
(b) every key the compiled step counts maps to exactly one signature (the
    tree paths, shapes and dtypes of the state and batch the step sees);
(c) ``make_train_step``'s whole step runs under ``FakeTensorMode`` for all
    ten archs at 1 and 2 microbatches, the flash call replaced by a
    stand-in of the kernel's output shape where the card routes to the
    kernel (on the card the kernel itself is captured); an ``.item()`` in
    the loss and a Python-float learning rate taken from the step count
    raise there;
(d) the static batch buffers (``_StaticBatch``, reused step after step as
    a graph's are) leave the parameters, m, v, step and metrics bitwise
    those of ``make_train_step`` on the batches themselves;
(e) the capture tally of ``kernels.build`` takes the bumps another thread
    makes on the capturing stream (autograd's device thread) and counts
    an unrelated thread's at once;
and a step with remat draws no random number, so the generator state the
remat checkpoint stashes (captured with it on the card) restores nothing
a recompute reads.
"""

import functools
import threading

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           FakeTensorMode)
from torch.utils._pytree import tree_map as pytree_map

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import SyntheticLMData as RefData
from repro.models import build_model as ref_build
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import Trainer as RefTrainer
from repro_torch.configs import ALL_ARCHS, get_smoke_config
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.models import attention, build_model, from_jax_params
from repro_torch.train import AdamWConfig, Trainer, make_train_step, optim
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.optim import adamw_init, tree_items, tree_leaves

torch.backends.cuda.matmul.allow_tf32 = False

OPT = dict(lr=1e-2, warmup_steps=2, total_steps=50, weight_decay=0.01)
#: (global batch, seq) of each step: three shapes, each met again later
SHAPES = [(4, 16), (4, 16), (4, 32), (2, 16), (4, 16), (4, 32)]
WHISPER_SHAPES = [(2, 16), (2, 8), (2, 16)]


def _extras(cfg):
    if cfg.frontend == "frames":
        return {"frames": (cfg.encoder_ctx, cfg.d_model)}
    if cfg.frontend == "patches":
        return {"patch_embeds": (cfg.n_frontend_tokens, cfg.d_model)}
    return {}


@functools.lru_cache(maxsize=None)
def _run(arch, n, shapes):
    """The reference ``Trainer`` and the port's over one batch per shape in
    ``shapes`` (data seeded by step), from the same weights.  Returns the
    two cache sizes, both packages' losses, and the port's signatures by
    key."""
    ref_cfg = ref_smoke_config(arch).scaled(num_microbatches=n)
    cfg = get_smoke_config(arch).scaled(num_microbatches=n)
    ref = RefTrainer(ref_build(ref_cfg), RefAdamWConfig(**OPT))
    ref_state = ref.init(jax.random.key(0))
    port = Trainer(build_model(cfg), AdamWConfig(**OPT), device="cpu")
    params = from_jax_params(cfg, jax.tree.map(np.asarray,
                                               ref_state["params"]),
                             device="cpu", master=True)
    state = {"params": params, "opt": adamw_init(params)}
    keys, signatures = [], {}
    real_key, real_step = trainer_mod._signature, port._step_fn._step

    def spy_key(state, batch):
        keys.append(real_key(state, batch))
        return keys[-1]

    def spy_step(state, batch):
        seen = (tuple((path, tuple(x.shape), str(x.dtype))
                      for path, x in tree_items(state)),
                tuple((k, np.shape(v), np.asarray(v).dtype.str)
                      for k, v in sorted(batch.items())))
        signatures.setdefault(keys[-1], set()).add(seen)
        return real_step(state, batch)

    trainer_mod._signature = spy_key
    port._step_fn._step = spy_step
    losses = ([], [])
    try:
        for i, (b, s) in enumerate(shapes):
            batch = RefData(cfg.vocab_size, s, b,
                            extras=_extras(cfg)).batch_at(i)
            ref_state = ref.run(ref_state, iter([batch]), steps=1,
                                on_metrics=lambda _, m: losses[0].append(
                                    m["loss"]))
            state = port.run(state, iter([batch]), steps=1,
                             on_metrics=lambda _, m: losses[1].append(
                                 m["loss"]))
    finally:
        trainer_mod._signature = real_key
    return dict(ref_count=ref._step_fn._cache_size(),
                count=port._step_fn._cache_size(), losses=losses,
                signatures=signatures)


CASES = [("stablelm-3b", 1, tuple(SHAPES)), ("stablelm-3b", 2, tuple(SHAPES)),
         ("whisper-small", 1, tuple(WHISPER_SHAPES))]
IDS = ["stablelm-3b-1mb", "stablelm-3b-2mb", "whisper-small"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cache_size_equals_reference(case):
    run = _run(*case)
    assert run["count"] == run["ref_count"] == len(set(case[2]))
    for got, want in zip(*reversed(run["losses"])):
        assert got == pytest.approx(want, rel=1e-4)
    assert len(run["losses"][1]) == len(case[2])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_signature_per_key(case):
    run = _run(*case)
    assert len(run["signatures"]) == run["count"]
    for key, sigs in run["signatures"].items():
        assert len(sigs) == 1, (key, sigs)


# ------------------------------------------------- (c) fake tensors
def _stand_in(q, k, v, *, causal=True):
    """The flash kernel's output shape, differentiable in q, k and v (the
    card captures the kernel)."""
    return q + 0 * (k.sum() + v.sum())


def _fake_step(arch, n, monkeypatch, model=None):
    """``make_train_step``'s step of the smoke ``arch`` at ``n``
    microbatches under ``FakeTensorMode``, the flash route taken as on
    "cuda" with the kernel call replaced by ``_stand_in``: returns the
    metrics' shapes, or raises where the step needs a value on the
    host."""
    cfg = get_smoke_config(arch).scaled(num_microbatches=n)
    model = model or build_model(cfg)
    route = attention.flash_route
    monkeypatch.setattr(attention, "flash_route",
                        lambda device, *a, **kw: route("cuda", *a, **kw))
    monkeypatch.setattr(flash_kernel, "flash_attention", _stand_in)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu", master=True)
    batch = RefData(cfg.vocab_size, 8, 2 * n,
                    extras=_extras(cfg)).batch_at(0)
    mode = FakeTensorMode()
    fake = pytree_map(mode.from_tensor, params)
    fake_batch = {k: mode.from_tensor(torch.from_numpy(v))
                  for k, v in batch.items()}
    k0 = attention.FLASH_ROUTES["kernel"].n
    with mode:
        state = {"params": fake, "opt": adamw_init(fake)}
        state, metrics = make_train_step(model, AdamWConfig(**OPT))(
            state, fake_batch)
    assert all(p.grad is None for p in tree_leaves(state["params"]))
    return ({k: tuple(v.shape) for k, v in metrics.items()},
            attention.FLASH_ROUTES["kernel"].n - k0)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_runs_under_fake_tensors(arch, n, monkeypatch):
    shapes, kernel_calls = _fake_step(arch, n, monkeypatch)
    assert shapes == {"loss": (), "lr": (), "grad_norm": ()}
    if arch == "stablelm-3b":
        # the stand-in is reached: the card's kernel route, one a layer
        assert kernel_calls == get_smoke_config(arch).n_layers * n


class _SyncingLoss:
    """A model whose loss reads its value on the host (``.item()``)."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def loss(self, params, batch):
        loss = self.model.loss(params, batch)
        return loss * (1 + 0 * loss.item())


def _python_lr(cfg, step):
    """A warmup taken as a Python float from the step count: it would
    freeze at the captured step."""
    return cfg.lr * min(1.0, float(step) / max(cfg.warmup_steps, 1))


@pytest.mark.parametrize("fault", ["item", "lr"])
def test_host_syncs_fail_under_fake_tensors(fault, monkeypatch):
    """The controls: a host read in the loss or in the schedule needs a
    value that fake tensors refuse."""
    cfg = get_smoke_config("stablelm-3b")
    model = None
    if fault == "item":
        model = _SyncingLoss(build_model(cfg))
    else:
        monkeypatch.setattr(optim, "lr_schedule", _python_lr)
    with pytest.raises(DataDependentOutputException):
        _fake_step("stablelm-3b", 1, monkeypatch, model=model)


# ------------------------------------------- (d) static == the batches
@pytest.mark.parametrize("n", [1, 2, 4])
def test_static_batch_equals_make_train_step(n):
    cfg = get_smoke_config("stablelm-3b").scaled(num_microbatches=n)
    ref_cfg = ref_smoke_config("stablelm-3b")
    base = from_jax_params(cfg, jax.tree.map(
        np.asarray, ref_build(ref_cfg).init(jax.random.key(0))),
        device="cpu", master=True)
    states = []
    for _ in range(2):
        p = pytree_map(lambda x: x.clone(), base)
        states.append({"params": p, "opt": adamw_init(p)})
    step = make_train_step(build_model(cfg), AdamWConfig(**OPT))
    data = RefData(cfg.vocab_size, 16, 4)
    inputs, kept = None, []
    for i in range(3):
        batch = data.batch_at(i)
        _, want = step(states[0], batch)
        tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
        if inputs is None:
            inputs = trainer_mod._StaticBatch(tensors, torch.device("cpu"))
        inputs.load(tensors)
        _, got = step(states[1], inputs.tensors)
        got = {k: v.clone() for k, v in got.items()}
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
        kept.append((got, want))
    for (path, a), (_, b) in zip(tree_items(states[1]), tree_items(states[0])):
        assert torch.equal(a, b), path
    assert int(states[1]["opt"]["step"]) == 3
    assert all(torch.equal(g[k], w[k]) for g, w in kept for k in w)
    bad = dict(tensors, tokens=tensors["tokens"][:, :8])
    with pytest.raises(ValueError):
        inputs.load(bad)


# ------------------------------------------------ (e) capture tally
class _Stream:
    cuda_stream = 7


def test_tally_follows_the_capturing_stream(monkeypatch):
    """A bump from a thread that did not open the capture lands in it when
    the thread launches on the capturing stream (as autograd's device
    thread runs a captured forward's backward); a thread on another
    stream, or on none capturing, counts at once; after the capture the
    stream counts at once again."""
    on = threading.local()
    monkeypatch.setattr(build, "_stream_key",
                        lambda: getattr(on, "stream", None))
    a = build.Counter()
    seen = []

    def thread(stream, fn):
        def body():
            on.stream = stream
            fn()
        t = threading.Thread(target=body)
        t.start()
        t.join()

    def backward():
        a.bump()
        a.bump()
        build.at_replay(lambda: seen.append(a.n))
        seen.append(build.launched(a))

    with build.capturing(_Stream()) as tally:
        a.bump()  # the capturing thread itself
        thread(7, backward)
        thread(9, a.bump)  # another stream: not this capture's
        thread(None, a.bump)  # a stream that is not capturing
        assert a.n == 2
        assert build.launched(a) == 2 + 3
    assert seen == [3]
    assert tally.counts == {a: 3}
    thread(7, a.bump)
    assert a.n == 3 and not build._stream_tallies
    tally.replay()
    assert a.n == 6 and seen == [3, 6]


def test_stream_tallies_nest_and_restore(monkeypatch):
    on = threading.local()
    monkeypatch.setattr(build, "_stream_key",
                        lambda: getattr(on, "stream", None))
    a = build.Counter()
    with build.capturing(_Stream()) as outer:
        with build.capturing(_Stream()) as inner:
            t = threading.Thread(target=lambda: (
                setattr(on, "stream", 7), a.bump()))
            t.start()
            t.join()
        t = threading.Thread(target=lambda: (setattr(on, "stream", 7),
                                             a.bump()))
        t.start()
        t.join()
    assert (inner.counts, outer.counts, a.n) == ({a: 1}, {a: 1}, 0)
    with pytest.raises(RuntimeError):
        with build.capturing(_Stream()):
            raise RuntimeError("a failed capture")
    assert not build._stream_tallies


# ------------------------------------------- remat, no random number
@pytest.mark.parametrize("arch", ["stablelm-3b", "recurrentgemma-2b",
                                  "whisper-small"])
def test_remat_step_draws_no_random_number(arch):
    """A train step with remat leaves the generator where it was, and its
    gradients do not depend on the generator's state."""
    cfg = get_smoke_config(arch).scaled(remat=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu",
                        master=True)
    batch = RefData(cfg.vocab_size, 8, 2, extras=_extras(cfg)).batch_at(0)
    grads = []
    for seed in (0, 1234):
        torch.manual_seed(seed)
        before = torch.get_rng_state()
        live = trainer_mod.bind_grads(params)
        model.loss(live, {k: torch.from_numpy(v)
                          for k, v in batch.items()}).backward()
        assert torch.equal(torch.get_rng_state(), before)
        grads.append([p.grad.clone() for p in tree_leaves(params)])
        for p in tree_leaves(params):
            p.grad = None
    assert all(torch.equal(a, b) for a, b in zip(*grads))
