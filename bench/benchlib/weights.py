"""Seeded weights for a dense GQA decoder, in the parameter tree that
``repro_torch``'s paged serving steps read, made on the device from
``--seed`` in a few large calls.

The tree (one ``attn`` block per layer, stacked along a leading layer
axis): ``embed/table`` (V, d); ``groups/b0_attn/{norm_mix, mix, norm_mlp,
mlp}`` with ``mix/{wq, wk, wv}`` (L, d, heads x head_dim), ``mix/wo``
(L, H x head_dim, d), ``mlp/{wi_gate, wi_up}`` (gated) or ``mlp/wi``, and
``mlp/wo``; ``final_norm``; ``head/kernel`` (d, V).  Matrices are stored in
the served type (bf16), norm scales and biases in f32, as the port stores
them.  The plain reference reads the same tensors (``reference.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def shapes(arch: dict) -> List[Tuple[Tuple[str, ...], tuple, str]]:
    """(path, shape, kind) of every leaf; kind is ``embed`` (unit normal),
    ``dense`` (normal of std 1/sqrt(fan-in)) or ``norm``."""
    d, v, L = arch["d_model"], arch["vocab_size"], arch["n_layers"]
    h, kh = arch["n_heads"], arch["n_kv_heads"]
    hd = arch.get("head_dim") or d // h
    f = arch["d_ff"]
    norm_keys = ("scale", "bias") if arch["norm_kind"] == "layernorm" \
        else ("scale",)
    blk = ("groups", "b0_attn")
    out = [(("embed", "table"), (v, d), "embed")]
    for n in ("norm_mix", "norm_mlp"):
        out += [(blk + (n, k), (L, d), "norm") for k in norm_keys]
    out += [(blk + ("mix", "wq"), (L, d, h * hd), "dense"),
            (blk + ("mix", "wk"), (L, d, kh * hd), "dense"),
            (blk + ("mix", "wv"), (L, d, kh * hd), "dense"),
            (blk + ("mix", "wo"), (L, h * hd, d), "dense")]
    gated = arch["mlp_kind"] in ("swiglu", "geglu")
    ins = ("wi_gate", "wi_up") if gated else ("wi",)
    out += [(blk + ("mlp", n), (L, d, f), "dense") for n in ins]
    out += [(blk + ("mlp", "wo"), (L, f, d), "dense")]
    out += [(("final_norm", k), (d,), "norm") for k in norm_keys]
    out += [(("head", "kernel"), (d, v), "dense")]
    return out


def count(arch: dict, kinds=("dense",)) -> int:
    return sum(math.prod(s) for _, s, k in shapes(arch) if k in kinds)


def make_params(arch: dict, seed: int, device, dtype=torch.bfloat16,
                norm_std: float = 0.1) -> Dict:
    """The tree, drawn from ``seed``: one normal draw for every matrix (in
    ``dtype``), scaled in place leaf by leaf, and one f32 draw for the
    norms (std ``norm_std`` around the port's zero-centred scale, so scale
    and bias both reach the result)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    leaves = shapes(arch)
    big = [(p, s, k) for p, s, k in leaves if k != "norm"]
    small = [(p, s, k) for p, s, k in leaves if k == "norm"]
    mats = torch.randn(sum(math.prod(s) for _, s, _ in big), generator=gen,
                       device=device, dtype=dtype)
    norms = torch.randn(sum(math.prod(s) for _, s, _ in small), generator=gen,
                        device=device, dtype=torch.float32)
    tree: Dict = {}
    for buf, group in ((mats, big), (norms, small)):
        off = 0
        for path, shape, kind in group:
            n = math.prod(shape)
            t = buf[off:off + n].view(shape)
            off += n
            if kind == "dense":
                t.mul_(1.0 / math.sqrt(shape[-2]))
            elif kind == "norm":
                t.mul_(norm_std)
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = t
    return tree


def leaf(tree: Dict, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree
