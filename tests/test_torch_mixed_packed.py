"""The engine's mixed step on one packed token axis (``paged_mixed_step``)
held against the ragged (B, C) chunk step on the CPU's plain kernels.

A mixed plan is its decode rows plus one prompt chunk.  The engine runs it
as ``max_batch`` decode slots and the chunk's bucket on one axis (exact
sizes with ``pad_shapes`` off), with the decode kernel over the decode
slots and the chunk kernel over the chunk.  For every mixed plan of a
served trace with prefix-aliased, ragged prompts, on the stablelm-3b,
starcoder2-3b and gemma-7b smoke configs, over f32, bf16 and int8 pages,
with ``pad_shapes`` on and off:

(a) packed against padded: the packed step's logits match
    ``paged_prefill_chunk`` on the plan's own ragged (B, C) rows, its
    pages at every written (block, offset) are the ragged step's, and it
    writes nothing else but the scratch slot (int8: nothing outside the
    blocks it re-codes);
(b) static against derived: the engine's host-built write blocks and int8
    re-code list leave the pools bitwise what the step derives itself
    from the tables, with the same sampled ids.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine
from repro_torch.serve.paged_model import paged_mixed_step, paged_prefill_chunk

#: limits of the packed step against the ragged one, which differ only in
#: the GEMMs' row counts (M): logits within 1e-4 (the paged steps' parity
#: tests hold them to 2e-3 against the reference; here 2.3e-5 is the most
#: seen), pages within 1e-5 in f32 (1.2e-6 seen) and one rounding step in
#: bf16 (a K or V value an ulp of f32 apart may round to the next bf16) or
#: int8 (the code), scales within 1e-5
LOGITS = dict(rtol=1e-4, atol=1e-4)
PAGES = {torch.float32: dict(rtol=1e-5, atol=1e-5),
         torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5)}
ARCHS = ["stablelm-3b", "starcoder2-3b", "gemma-7b"]
KV = [None, "bf16", "int8"]
SYSTEM = [[1 + j % 13 for j in range(8)], [3 + j % 7 for j in range(8)]]


def _prompts():
    """8 prompts on two block-aligned 8-token prefixes (the prefix cache
    aliases their pages) with ragged tails of 1-9 tokens, and 4 unshared
    prompts of 3-20 tokens."""
    rng = np.random.default_rng(5)
    tails = [SYSTEM[i % 2] + [int(t) for t in
                              rng.integers(1, 200, int(rng.integers(1, 10)))]
             for i in range(8)]
    return tails + [[int(t) for t in rng.integers(1, 200, int(n))]
                    for n in rng.integers(3, 21, 4)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _written(plan, tables, bs):
    """(block, offset) of every token the plan writes: each decode row's
    one token and the chunk's valid ones, through the plan's tables."""
    out = set()
    for i, n in enumerate(plan.chunk_lens):
        for p in plan.positions[i, :n]:
            out.add((int(tables[i, p // bs]), int(p % bs)))
    return out


def _check_plan(engine, plan, arrays, pools, seen):
    cfg, params, bs = engine.cfg, engine.params, engine.block_size
    b, nd = len(plan.requests), plan.n_decode
    scratch = engine._shard_sizes[plan.shard]
    before = {k: v.clone() for k, v in pools.items()}
    # (b) the static write indices against the derived ones
    derived = {k: v.clone() for k, v in pools.items()}
    lg_derived, _ = paged_mixed_step(cfg, params, derived,
                                     *map(_t, arrays[:4]))
    static = {k: v.clone() for k, v in pools.items()}
    lg, _ = paged_mixed_step(cfg, params, static,
                             *[None if a is None else _t(a) for a in arrays])
    for name in pools:
        assert torch.equal(static[name][:, :scratch],
                           derived[name][:, :scratch]), name
    assert torch.equal(torch.argmax(lg, -1), torch.argmax(lg_derived, -1))
    # (a) the plan's ragged (B, C) rows through the chunk step
    local = plan.tables.astype(np.int32) - engine._shard_bases[plan.shard]
    ragged = {k: v.clone() for k, v in pools.items()}
    lg_ragged, _ = paged_prefill_chunk(
        cfg, params, ragged, _t(local), _t(plan.tokens), _t(plan.positions),
        _t(plan.chunk_lens))
    np.testing.assert_allclose(lg[:b].numpy(), lg_ragged.numpy(), **LOGITS)
    written = _written(plan, local, bs)
    blk = torch.tensor(sorted(w[0] for w in written))
    off = torch.tensor([w[1] for w in sorted(written)])
    int8 = "k_scale" in pools
    for name in ("k", "v"):
        got, want = static[name][:, blk, off], ragged[name][:, blk, off]
        if int8:
            assert (got.int() - want.int()).abs().max() <= 1, name
        else:
            np.testing.assert_allclose(got.float().numpy(),
                                       want.float().numpy(),
                                       err_msg=name, **PAGES[got.dtype])
    if int8:
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(static[name][:, blk].numpy(),
                                       ragged[name][:, blk].numpy(),
                                       rtol=1e-5, atol=0, err_msg=name)
    # nothing written but the plan's tokens and the scratch slot
    for name in pools:
        changed = (static[name] != before[name])[:, :scratch]
        changed = changed.reshape(changed.shape[0], changed.shape[1], -1)
        if int8 or name.endswith("scale"):
            touched = {int(n) for n in changed.any(-1).any(0).nonzero()}
            assert touched <= {w[0] for w in written}, name
        else:
            where = changed.reshape(*changed.shape[:2], bs, -1).any(-1).any(0)
            touched = {(int(n), int(o)) for n, o in where.nonzero()}
            assert touched <= written, name
    n = int(plan.chunk_lens[-1])
    seen["mixed"] += 1
    seen["padded_columns"] += int(n < engine._chunk_bucket(n))
    seen["decode_rows"] = max(seen["decode_rows"], nd)
    # a request's first chunk past position 0 starts on aliased pages
    seen["aliased"] += int(plan.positions[-1, 0] > 0
                           and plan.requests[-1].rid not in seen["first"])
    seen["first"].add(plan.requests[-1].rid)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_smoke_config(request.param)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


@pytest.mark.parametrize("pad_shapes", [True, False], ids=["padded", "exact"])
@pytest.mark.parametrize("kv", KV, ids=["f32", "bf16", "int8"])
def test_packed_mixed_step_equals_ragged_chunk(model, kv, pad_shapes):
    cfg, params = model
    engine = ServeEngine(cfg, params, n_blocks=64, block_size=4, max_batch=4,
                         chunk_size=8, era_freq=1, cleanup_freq=1,
                         kv_dtype=kv, pad_shapes=pad_shapes, device="cpu")
    seen = {"mixed": 0, "padded_columns": 0, "aliased": 0, "decode_rows": 0,
            "first": set()}
    real = engine._run_step

    def spy(plan, step, arrays, b):
        if step is paged_mixed_step:
            _check_plan(engine, plan, arrays,
                        engine._shard_pools[plan.shard], seen)
        else:
            seen["first"].add(plan.requests[-1].rid)
        return real(plan, step, arrays, b)

    engine._run_step = spy
    tid = engine.pool.register_thread()
    reqs = [engine.submit(p, 5) for p in _prompts()]
    stats = engine.run(tid)
    assert all(len(r.generated) == 5 for r in reqs)
    assert engine.pool.unreclaimed() == 0
    assert engine.pool.free_blocks == 64
    assert stats["prefix_hits"] > 0
    assert seen["mixed"] > 0 and seen["decode_rows"] >= 2, seen
    assert seen["aliased"] > 0, seen
    assert (seen["padded_columns"] > 0) == pad_shapes, seen
