"""Serving steps on a mesh: prefill of S tokens into a cache of S + 4 slots,
then two greedy decode steps, with DTensor parameters, tokens, positions
and cache on a (2, 2) ("data", "model") mesh of four gloo ranks, against
the same steps on one device (seeded parameters).

This is the path the dry run's prefill and decode cells take on the
production meshes: the cache filled per shard (``sharding.axes.
per_shard``), the vocab-parallel embedding lookup, decode's indexed cache
write and its attention per shard (``local_map``), and the recurrent
states written back into the stacked DTensor cache.  stablelm-3b (full
attention), mixtral-8x7b (a ring cache past its window, MoE),
recurrentgemma-2b (RG-LRU state, a local-attention ring of 8) and
xlstm-350m (its mLSTM chunks and sLSTM steps run per batch row on the rank
that holds the row, ``sharding.axes.per_rows``).  Then one train step of
xlstm-350m and whisper-small (cross-attention over 1500 frames, 12 heads
over a model axis of 2) on DTensor masters against one device.  The
ranks run in one subprocess, joined by a ``FileStore`` (no port), under
its own timeout.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("stablelm-3b", "mixtral-8x7b", "recurrentgemma-2b", "xlstm-350m")
TRAIN_ARCHS = ("xlstm-350m", "whisper-small")

_RANKS = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    ARCHS = ("stablelm-3b", "mixtral-8x7b", "recurrentgemma-2b", "xlstm-350m")
    TRAIN_ARCHS = ("xlstm-350m", "whisper-small")
    B, S = 4, 16

    def steps(model, params, toks, lay):
        def last(logits):  # (B, V) at the last position
            return logits if logits.ndim == 2 else logits[:, -1]

        logits, cache = model.prefill(params, lay(toks, ("batch", None)),
                                      max_len=S + 4)
        out = [last(logits)]
        for i in range(2):
            tok = out[-1].argmax(-1).to(torch.int32)
            tok = tok.full_tensor() if hasattr(tok, "full_tensor") else tok
            pos = torch.full((B,), S + i, dtype=torch.int32)
            logits, cache = model.decode_step(
                params, cache, lay(tok, ("batch",)), lay(pos, ("batch",)))
            out.append(last(logits))
        return out

    def rank(r, out_dir):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                                rank=r, world_size=4)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import build_model
        from repro_torch.sharding.axes import (axis_rules, logical_to_spec,
                                               sharding_tree,
                                               spec_to_placements)
        from repro_torch.train.optim import tree_map

        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))

        def lay(x, names):
            pl = spec_to_placements(logical_to_spec(names, x.shape, mesh),
                                    mesh)
            return distribute_tensor(x, mesh, pl)

        res = {}
        for arch in ARCHS:
            cfg = get_smoke_config(arch)
            model = build_model(cfg)
            params = model.init(torch.Generator().manual_seed(0),
                                device="cpu")
            toks = torch.randint(0, cfg.vocab_size, (B, S),
                                 generator=torch.Generator().manual_seed(1),
                                 dtype=torch.int32)
            with torch.no_grad():
                one = steps(model, params, toks, lambda x, names: x)
                placed = tree_map(
                    lambda leaf, pl: distribute_tensor(leaf, mesh, pl),
                    params, sharding_tree(params, model.params_axes(), mesh))
                with axis_rules(mesh):
                    got = steps(model, placed, toks, lay)
            res[arch] = np.stack([g.full_tensor().numpy() for g in got])
            res[f"{arch}:one"] = np.stack([o.numpy() for o in one])
        from repro_torch.train import AdamWConfig
        from repro_torch.train.optim import adamw_init, tree_leaves
        from repro_torch.train.trainer import make_train_step

        for arch in TRAIN_ARCHS:
            cfg = get_smoke_config(arch)
            model = build_model(cfg)
            gen = torch.Generator().manual_seed(2)
            toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                                 dtype=torch.int32)
            batch = {"tokens": toks[:, :-1].contiguous(),
                     "labels": toks[:, 1:].contiguous()}
            if cfg.frontend == "frames":
                batch["frames"] = torch.randn(
                    (B, cfg.encoder_ctx, cfg.d_model), generator=gen)

            def state():
                params = model.init(torch.Generator().manual_seed(0),
                                    device="cpu", master=True)
                return {"params": params, "opt": adamw_init(params)}

            opt = AdamWConfig(warmup_steps=1)
            one, m1 = make_train_step(model, opt)(state(), batch)
            st = state()
            st["params"] = tree_map(
                lambda leaf, pl: distribute_tensor(leaf, mesh, pl),
                st["params"], sharding_tree(st["params"],
                                            model.params_axes(), mesh))
            st["opt"] = adamw_init(st["params"])
            with axis_rules(mesh):
                st, m = make_train_step(model, opt)(st, batch)
            res[f"{arch}:train"] = np.array([float(m["loss"]),
                                             float(m1["loss"])])
            res[f"{arch}:train_diff"] = np.array(max(
                (a.full_tensor() - b).abs().max().item() for a, b in zip(
                    tree_leaves(st["params"]), tree_leaves(one["params"]))))
        np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(rank, args=(sys.argv[1],), nprocs=4)
        print("RANKS_OK")
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_decode")
    script = out / "ranks.py"
    script.write_text(_RANKS)
    res = subprocess.run(
        [sys.executable, str(script), str(out)], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert "RANKS_OK" in res.stdout, res.stdout + "\n" + res.stderr[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_a_mesh_match_one_device(ranks, arch):
    """The last-position logits of the prefill and of each decode step,
    on every rank, within the SPMD limits of ``test_torch_multirank``."""
    for res in ranks:
        np.testing.assert_allclose(res[arch], res[f"{arch}:one"], rtol=2e-4,
                                   atol=2e-4, err_msg=arch)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_a_mesh_matches_one_device(ranks, arch):
    """Loss within 2e-5 relative and every updated parameter within 1e-5
    of the one-device step, as ``test_torch_multirank`` holds stablelm's."""
    for res in ranks:
        loss, one = res[f"{arch}:train"]
        assert loss == pytest.approx(one, rel=2e-5), arch
        assert float(res[f"{arch}:train_diff"]) < 1e-5, arch
