"""The port's training substrate (``repro_torch.train``, ``repro_torch.data``,
``repro_torch.launch.train``) held against ``repro`` on the CPU.

Weights come from one reference pytree (``build_model(cfg).init(key(0))``)
carried over by ``from_jax_params(..., master=True)`` (every leaf f32, the
reference's master weights); tokens, labels, extras, parameters and
gradients for the optimizer from a NumPy seed.  Tolerances:

* AdamW and the schedule: 1e-6 (f32; the two sum the global norm in
  different orders);
* gradients of ``lm_loss``: each leaf within 1e-4 of its largest
  |gradient| plus 1e-4 relative (f32 sums in different orders; measured
  within 6e-6 on every arch);
* three train steps: loss relative 1e-4, parameters 1e-4;
* the plain flash backward against ``jax.vjp`` of the reference's
  attention: 1e-5 (f32).

On the CPU every attention call takes the plain route: the tests that
train assert that ``FLASH_ROUTES["kernel"]`` does not move.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import PrefetchingLoader as RefLoader
from repro.data import SyntheticLMData as RefData
from repro.models import build_model as ref_build
from repro.models.attention import flash_attention as ref_flash
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import make_train_step as ref_make_train_step
from repro.train.checkpoint import Checkpointer as RefCheckpointer
from repro.train.optim import adamw_init as ref_adamw_init
from repro.train.optim import adamw_update as ref_adamw_update
from repro.train.optim import lr_schedule as ref_lr_schedule
from repro_torch.configs import ALL_ARCHS, get_smoke_config
from repro_torch.data import PrefetchingLoader, SyntheticLMData
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.launch import train as train_cli
from repro_torch.models import attention, build_model, from_jax_params
from repro_torch.models.params import init_params
from repro_torch.train import AdamWConfig, Trainer, make_train_step
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault_tolerance import run_with_restarts
from repro_torch.train.optim import (adamw_init, adamw_update, global_norm,
                                     lr_schedule, tree_items, tree_leaves,
                                     tree_map)
from repro_torch.train.trainer import bind_grads, init_train_state

torch.backends.cuda.matmul.allow_tf32 = False

B, S = 2, 16
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=50, weight_decay=0.01)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close_tree(got, want, rtol, atol):
    """Every leaf of the port's tree (sorted keys) against the reference's
    pytree of the same structure."""
    items = tree_items(got)
    ref_leaves = jax.tree.leaves(want)
    assert len(items) == len(ref_leaves)
    for (path, g), r in zip(items, ref_leaves):
        np.testing.assert_allclose(
            g.detach().numpy(), np.asarray(r), rtol=rtol, atol=atol,
            err_msg="/".join(path))


def _models(arch, **scale):
    ref_cfg = ref_smoke_config(arch).scaled(**scale)
    cfg = get_smoke_config(arch).scaled(**scale)
    ref_params = ref_build(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, _np_tree(ref_params), device="cpu",
                             master=True)
    return ref_cfg, cfg, ref_params, params


def _batch(cfg, seed):
    """Seeded tokens, labels (a few padded) and the arch's extras."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch["labels"][0, :3] = -1
    if cfg.frontend == "patches":
        batch["patch_embeds"] = 0.02 * rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "frames":
        batch["frames"] = 0.02 * rng.standard_normal(
            (B, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)
    return batch


def _grads(cfg, params, batch):
    """Gradients of the port's ``lm_loss`` w.r.t. every leaf (sorted keys;
    an unused leaf's gradient is zero, as jax.grad gives)."""
    items = tree_items(params)
    leaves = [leaf.detach().requires_grad_() for _, leaf in items]
    live = _rebuild(params, leaves)
    loss = build_model(cfg).loss(live, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, [torch.zeros_like(l) if g is None else g
                  for l, g in zip(leaves, gs)]


def _rebuild(like, leaves):
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return next(it)

    return build(like)


# ================================================================ optimizer
def _opt_inputs(seed):
    """Seeded f32 parameters and three gradients of a nested tree."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": {"table": (16, 8)}, "groups": {"w": (3, 8, 4),
                                                      "b": (3, 4)},
              "final_norm": {"scale": (8,)}}
    p = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                     shapes, is_leaf=lambda x: isinstance(x, tuple))
    gs = [jax.tree.map(lambda s: (0.3 * rng.standard_normal(s)).astype(
        np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
        for _ in range(3)]
    return p, gs


@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_adamw_update_matches_reference(clip):
    """Three updates of the same parameters by the same gradients, with the
    clip active (global norm above 1) and inactive."""
    p, gs = _opt_inputs(seed=int(clip) % 7)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.1,
              grad_clip=clip)
    ref_cfg, cfg = RefAdamWConfig(**kw), AdamWConfig(**kw)
    rp = jax.tree.map(jnp.asarray, p)
    rs = ref_adamw_init(rp)
    tp = jax.tree.map(torch.from_numpy, p)
    ts = adamw_init(tp)
    for g in gs:
        rp, rs, rm = ref_adamw_update(ref_cfg, rp, jax.tree.map(jnp.asarray, g),
                                      rs)
        tp2, ts2, tm = adamw_update(cfg, tp, jax.tree.map(torch.from_numpy, g),
                                    ts)
        assert tp2 is tp and ts2 is ts  # in place
        for k in ("lr", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(rm[k]), rel=1e-6)
    _close_tree(tp, rp, rtol=1e-6, atol=1e-6)
    _close_tree(ts["m"], rs["m"], rtol=1e-6, atol=1e-6)
    _close_tree(ts["v"], rs["v"], rtol=1e-6, atol=1e-6)
    assert int(ts["step"]) == int(rs["step"]) == 3
    assert ts["step"].dtype == torch.int32


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_lr_schedule_matches_reference(step):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = float(ref_lr_schedule(RefAdamWConfig(**kw), jnp.asarray(step)))
    got = lr_schedule(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_adamw_minimizes_quadratic():
    """The reference's own optimizer check (test_train_data.py:27)."""
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=200, grad_clip=1e9)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = adamw_init(params)
    for _ in range(200):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        adamw_update(cfg, params, {"w": g}, state)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)
    assert int(state["step"]) == 200
    assert float(global_norm({"a": torch.ones(4)})) == 2.0


# ================================================================ gradients
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_gradients_match_reference(arch):
    """``lm_loss`` and its gradient w.r.t. every master leaf against
    ``jax.grad(model.loss)`` (f32 smoke config, a padded label row)."""
    ref_cfg, cfg, ref_params, params = _models(arch)
    batch = _batch(cfg, seed=len(arch))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_loss, ref_grads = jax.value_and_grad(ref_build(ref_cfg).loss)(
        ref_params, jb)
    k0 = attention.FLASH_ROUTES["kernel"].n
    loss, grads = _grads(cfg, params, batch)
    assert attention.FLASH_ROUTES["kernel"].n == k0
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    items = tree_items(params)
    for (path, _), g, r in zip(items, grads, jax.tree.leaves(ref_grads)):
        r = np.asarray(r)
        np.testing.assert_allclose(
            g.numpy(), r, rtol=1e-4, atol=1e-4 * max(np.abs(r).max(), 1e-12),
            err_msg="/".join(path))


@pytest.mark.parametrize("arch", ["stablelm-3b", "recurrentgemma-2b",
                                  "whisper-small"])
def test_remat_gradients_equal_plain(arch):
    """With ``remat`` each group runs under ``torch.utils.checkpoint``; the
    loss and gradients are the same bits as without it, and the
    reference's remat gradient matches as above."""
    ref_cfg, cfg, ref_params, params = _models(arch, remat=True)
    batch = _batch(cfg, seed=3)
    loss_r, grads_r = _grads(cfg, params, batch)
    loss_p, grads_p = _grads(cfg.scaled(remat=False), params, batch)
    assert torch.equal(loss_r, loss_p)
    for a, b in zip(grads_r, grads_p):
        assert torch.equal(a, b)
    ref_grads = jax.grad(ref_build(ref_cfg).loss)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    for g, r in zip(grads_r, jax.tree.leaves(ref_grads)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(r).max(), 1e-12))


def test_bound_aliases_accumulate_into_master_grads():
    """``bind_grads``: per-layer aliases of the stacked leaves share the
    masters' storage, and two backward passes sum into the masters'
    ``.grad`` what autograd gives for the stacked leaves themselves."""
    _, cfg, _, params = _models("whisper-small")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=5).items()}
    _, want = _grads(cfg, params, {k: v.numpy() for k, v in batch.items()})
    live = bind_grads(params)
    wq = params["groups"]["b0_attn"]["mix"]["wq"]
    alias = live["groups"]["b0_attn"]["mix"]["wq"]
    assert isinstance(alias, list) and len(alias) == cfg.n_groups
    assert alias[1].data_ptr() == wq[1].data_ptr() and alias[1].requires_grad
    assert isinstance(live["encoder"]["layers"]["mix"]["wq"], list)
    assert not isinstance(live["encoder"]["pos"]["pos"], list)
    model = build_model(cfg)
    for _ in range(2):
        model.loss(live, batch).backward()
    for (path, p), g in zip(tree_items(params), want):
        torch.testing.assert_close(p.grad, 2 * g, rtol=1e-5, atol=1e-7,
                                   msg="/".join(path))
        assert not p.requires_grad
        p.grad = None


# ============================================================ flash backward
def test_flash_bwd_ref_matches_reference_vjp():
    """The plain flash backward (autograd through the plain forward, the
    card kernel's yardstick) against ``jax.vjp`` of the reference's
    chunked attention, GQA, causal and not, T not a multiple of the query
    chunk.  (The key chunk divides T: where it does not, the reference's
    non-causal mask lets its zero pad keys into the softmax.)"""
    rng = np.random.default_rng(11)
    b, t, h, kh, d = 2, 40, 4, 2, 16
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((b, t, h, d), (b, t, kh, d), (b, t, kh, d), (b, t, h, d)))
    pos = jnp.broadcast_to(jnp.arange(t)[None], (b, t))
    for causal in (True, False):
        _, vjp = jax.vjp(lambda q_, k_, v_: ref_flash(
            q_, k_, v_, pos, pos, causal=causal, q_chunk=16, kv_chunk=8),
            *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp(jnp.asarray(do))
        got = flash_attention_bwd_ref(*(torch.from_numpy(x) for x in
                                        (q, k, v, do)), causal=causal)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


def test_noncausal_pad_keys_follow_the_reference():
    """Where the key chunk does not divide T, the reference's non-causal
    chunked attention (``repro/models/attention.py:70``) lets its zero pad
    keys into the softmax (only the causal mask drops keys past T); the
    port's plain route copies that, the exact attention (the CUDA kernel's
    semantics, ``flash_attention_ref``) does not.  Whisper-small's encoder
    (1500 frames, key chunks of 512) is such a case at full size."""
    from repro_torch.models.attention import flash_attention as port_flash

    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 40, 2, 8)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(40)[None]
    want = np.asarray(ref_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                jnp.asarray(pos), jnp.asarray(pos),
                                causal=False, q_chunk=16, kv_chunk=16))
    tq, tk, tv, tpos = (torch.from_numpy(np.ascontiguousarray(x))
                        for x in (q, k, v, pos))
    got = port_flash(tq, tk, tv, tpos, tpos, causal=False, q_chunk=16,
                     kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    exact = flash_attention_ref(tq, tk, tv, causal=False).numpy()
    assert np.abs(exact - want).max() > 1e-2


def test_flash_bwd_algebra_of_the_kernel():
    """The CUDA backward's algebra in plain PyTorch: P recomputed from the
    row log-sum-exp, Delta = rowsum(dO * O), dS = P (dP - Delta), dQ and
    dK scaled, dK and dV summed over each kv head's G query heads, in f64,
    equals autograd through the plain forward (f32 inside) within f32
    rounding."""
    rng = np.random.default_rng(4)
    b, t, h, kh, d = 1, 24, 6, 2, 8
    g = h // kh
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .double() for s in ((b, t, h, d), (b, t, kh, d),
                                       (b, t, kh, d), (b, t, h, d)))
    scale = d ** -0.5
    kr, vr = (x.repeat_interleave(g, 2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) * scale
    mask = torch.ones(t, t, dtype=torch.bool).tril()
    s = torch.where(mask, s, -torch.inf)
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.exp(s - lse)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    delta = torch.einsum("bqhd,bqhd->bhq", do, o)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vr)
    ds = p * (dp - delta)
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dk, dv = (x.reshape(b, t, kh, g, d).sum(3) for x in (dk, dv))
    # the plain version computes in f32 inside: f32 rounding (1e-5)
    want = flash_attention_bwd_ref(q, k, v, do, causal=True)
    torch.testing.assert_close(o, flash_attention_ref(q, k, v), rtol=1e-5,
                               atol=1e-6)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-6)


# ================================================================ trainer
@pytest.fixture(scope="module")
def tiny():
    ref_cfg, cfg, ref_params, params = _models("stablelm-3b",
                                               num_microbatches=2)
    data = RefData(cfg.vocab_size, seq_len=16, global_batch=4)
    return ref_cfg, cfg, ref_params, params, data


@pytest.mark.parametrize("n", [1, 2, 4])
def test_train_steps_match_reference(tiny, n):
    """Three ``make_train_step`` steps from the same master weights on the
    same batches, with ``n`` microbatches, against the reference's."""
    ref_cfg, cfg, ref_params, params, data = tiny
    ref_cfg, cfg = (c.scaled(num_microbatches=n) for c in (ref_cfg, cfg))
    ref_step = jax.jit(ref_make_train_step(ref_build(ref_cfg),
                                           RefAdamWConfig(**OPT)))
    step = make_train_step(build_model(cfg), AdamWConfig(**OPT))
    ref_state = {"params": ref_params, "opt": ref_adamw_init(ref_params)}
    p = tree_map(lambda x: x.clone(), params)  # the fixture's stay as drawn
    state = {"params": p, "opt": adamw_init(p)}
    k0 = attention.FLASH_ROUTES["kernel"].n
    for i in range(3):
        batch = data.batch_at(i)
        ref_state, rm = ref_step(ref_state, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-4)
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                      rel=1e-4)
    assert attention.FLASH_ROUTES["kernel"].n == k0
    _close_tree(state["params"], ref_state["params"], rtol=1e-4, atol=1e-4)
    assert int(state["opt"]["step"]) == 3
    assert all(p.grad is None for p in tree_leaves(state["params"]))


def test_train_loss_decreases(tiny):
    """The reference's trainer check (test_train_data.py:62) on the port."""
    _, cfg, _, _, data = tiny
    trainer = Trainer(build_model(cfg), AdamWConfig(**OPT), device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    assert all(leaf.dtype == torch.float32
               for leaf in tree_leaves(state["params"]))
    losses = []
    trainer.run(state, data.stream(0), steps=20,
                on_metrics=lambda s, m: losses.append(m["loss"]))
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_trainer_defaults_to_cuda(tiny):
    _, cfg, _, _, _ = tiny
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(build_model(cfg), AdamWConfig(**OPT))


def test_master_storage_keeps_param_dtype():
    """``master=True`` keeps every leaf in ``param_dtype`` where the
    serving storage casts the matmul and embedding leaves to ``dtype``."""
    cfg = get_smoke_config("stablelm-3b").scaled(dtype=torch.bfloat16)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    serve = init_params(cfg, gen(), device="cpu")
    master = init_params(cfg, gen(), device="cpu", master=True)
    assert serve["embed"]["table"].dtype == torch.bfloat16
    assert all(l.dtype == torch.float32 for l in tree_leaves(master))
    for (path, s), m in zip(tree_items(serve), tree_leaves(master)):
        assert torch.equal(m.to(s.dtype), s), path


# ================================================================ data
@pytest.mark.parametrize("seed,hosts,host,extras", [
    (0, 1, 0, None), (3, 2, 1, None), (7, 4, 2, {"frames": (6, 8)}),
])
def test_synthetic_data_is_the_reference(seed, hosts, host, extras):
    kw = dict(seed=seed, n_hosts=hosts, host_id=host, extras=extras)
    ref, port = RefData(100, 12, 8, **kw), SyntheticLMData(100, 12, 8, **kw)
    for step in (0, 1, 17):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert np.array_equal(next(port.stream(5))["tokens"],
                          ref.batch_at(5)["tokens"])


def test_prefetching_loader_reclaims():
    """The reference's prefetch check on the port's WFE: batches in order,
    and after ``close`` every consumed generation is reclaimed."""
    d = SyntheticLMData(100, 4, 2, seed=1)
    loader = PrefetchingLoader(d, depth=2, start_step=3)
    ref = RefLoader(RefData(100, 4, 2, seed=1), depth=2, start_step=3)
    seen = [next(loader) for _ in range(10)]
    want = [next(ref) for _ in range(10)]
    ref.close()
    for got, w in zip(seen, want):
        np.testing.assert_array_equal(got["tokens"], w["tokens"])
    np.testing.assert_array_equal(seen[0]["tokens"], d.batch_at(3)["tokens"])
    assert loader.unreclaimed() >= 1  # the generation handed out last
    loader.close()
    assert loader.unreclaimed() == 0, "prefetch generations leaked"


# ================================================================ checkpoint
def test_checkpoint_roundtrip(tmp_path, tiny):
    _, cfg, _, _, data = tiny
    ckpt = Checkpointer(str(tmp_path), sync=True)
    trainer = Trainer(build_model(cfg), AdamWConfig(**OPT), checkpointer=ckpt,
                      checkpoint_every=5, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    state = trainer.run(state, data.stream(0), steps=10)
    man = ckpt.latest_manifest()
    assert man is not None and man["step"] == 10
    assert man["paths"][0] == "['opt']['m']['embed']['table']"
    assert "['params']['groups']['b0_attn']['mix']['wq']" in man["paths"]
    restored = ckpt.restore(state)
    for (path, a), b in zip(tree_items(restored), tree_leaves(state)):
        assert a.dtype == b.dtype and a.device == b.device, path
        assert torch.equal(a, b), path
    assert ckpt.unreclaimed_generations() <= 1


def test_checkpoint_snapshot_is_a_copy(tmp_path):
    """``save`` copies the state to the host before it returns: an in-place
    update made while the writer still holds the generation is not in the
    file."""
    ckpt = Checkpointer(str(tmp_path), sync=False)
    state = {"params": {"w": torch.zeros(4)}, "opt": {"step": torch.tensor(
        1, dtype=torch.int32)}}
    ckpt.save(1, state)
    state["params"]["w"].add_(5.0)
    ckpt.close()
    restored = ckpt.restore(state)
    assert torch.equal(restored["params"]["w"], torch.zeros(4))


def test_checkpoint_async_writer(tmp_path, tiny):
    _, cfg, _, _, data = tiny
    ckpt = Checkpointer(str(tmp_path), sync=False, keep_last=2)
    trainer = Trainer(build_model(cfg), AdamWConfig(**OPT), checkpointer=ckpt,
                      checkpoint_every=2, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    state = trainer.run(state, data.stream(0), steps=8)
    ckpt.close()
    man = ckpt.latest_manifest()
    assert man is not None and man["step"] >= 2
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert 0 < len(files) <= 2  # keep_last enforced


def test_fault_tolerant_restart(tmp_path, tiny):
    """An injected failure at step 12 of 20: the driver resumes from the
    manifest and reaches step 20 with one restart; the state equals an
    uninterrupted run's (the data replays by step)."""
    _, cfg, _, _, data = tiny
    model, opt = build_model(cfg), AdamWConfig(**OPT)
    ckpt = Checkpointer(str(tmp_path), sync=True)
    trainer = Trainer(model, opt, checkpointer=ckpt, checkpoint_every=5,
                      device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    fail_once = {"armed": True}

    def batches_factory(step):
        def gen():
            s = step
            while True:
                if fail_once["armed"] and s == 12:
                    fail_once["armed"] = False
                    raise RuntimeError("injected node failure")
                yield data.batch_at(s)
                s += 1
        return gen()

    restarts = []
    state = run_with_restarts(
        trainer, state, batches_factory, total_steps=20, chunk=10,
        on_restart=lambda n, e: restarts.append(str(e)))
    assert int(state["opt"]["step"]) == 20
    assert restarts == ["injected node failure"]
    assert ckpt.unreclaimed_generations() <= 1
    clean = Trainer(model, opt, device="cpu")
    want = clean.run(clean.init(torch.Generator().manual_seed(0)),
                     data.stream(0), steps=20)
    for a, b in zip(tree_leaves(state), tree_leaves(want)):
        assert torch.equal(a, b)


def test_checkpoints_cross_between_packages(tmp_path, tiny):
    """A checkpoint the reference wrote restores into the port's state, and
    one the port wrote restores into the reference's: same paths, order,
    bytes and checksum."""
    ref_cfg, cfg, ref_params, params, _ = tiny
    ref_state = {"params": ref_params, "opt": ref_adamw_init(ref_params)}
    ref_state["opt"]["step"] = jnp.asarray(7, jnp.int32)
    ref_ckpt = RefCheckpointer(str(tmp_path / "ref"), sync=True)
    ref_ckpt.save(7, ref_state)
    like = {"params": tree_map(torch.zeros_like, params),
            "opt": adamw_init(params)}
    got = Checkpointer(str(tmp_path / "ref"), sync=True).restore(like)
    _close_tree(got, ref_state, rtol=0, atol=0)
    assert got["opt"]["step"].dtype == torch.int32

    state = {"params": params, "opt": adamw_init(params)}
    state["opt"]["step"].fill_(9)
    port_ckpt = Checkpointer(str(tmp_path / "port"), sync=True)
    port_ckpt.save(9, state)
    ref_like = {"params": ref_params, "opt": ref_adamw_init(ref_params)}
    back = RefCheckpointer(str(tmp_path / "port"), sync=True).restore(ref_like)
    _close_tree(state, back, rtol=0, atol=0)
    with open(tmp_path / "port" / "manifest.json") as f:
        port_man = json.load(f)
    assert port_man["paths"] == ref_ckpt.latest_manifest()["paths"]


# ================================================================ CLI
def test_train_cli_on_cpu(tmp_path, capsys):
    """``launch.train.main`` with ``--device cpu``: trains, checkpoints,
    and a second run resumes from the manifest."""
    k0 = attention.FLASH_ROUTES["kernel"].n
    argv = ["--steps", "6", "--batch", "4", "--seq", "16", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "3", "--log-every", "3",
            "--device", "cpu"]
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "done: 6 steps" in out
    assert json.load(open(tmp_path / "manifest.json"))["step"] == 6
    assert train_cli.main(argv) == 0
    assert "resumed from step 6" in capsys.readouterr().out
    assert json.load(open(tmp_path / "manifest.json"))["step"] == 12
    assert attention.FLASH_ROUTES["kernel"].n == k0


def test_init_train_state_is_master_storage():
    cfg = get_smoke_config("gemma-7b").scaled(dtype=torch.bfloat16)
    state = init_train_state(build_model(cfg), torch.Generator().manual_seed(1),
                             AdamWConfig(), device="cpu")
    assert all(l.dtype == torch.float32 for l in tree_leaves(state["params"]))
    assert all(l.dtype == torch.float32 and not l.any()
               for l in tree_leaves(state["opt"]["m"]))
    assert state["opt"]["step"].dtype == torch.int32
