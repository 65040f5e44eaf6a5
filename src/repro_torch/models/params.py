"""Parameter trees of the model zoo: a seeded init and the reference bridge.

Both build the key and shape tree of ``repro.models.transformer.init_params``
for every architecture: per-layer weights stacked along a leading group
axis under ``groups/b{j}_{kind}`` (GQA or MLA attention, RG-LRU, mLSTM or
sLSTM mixes; dense or MoE FFNs, shared experts included; whisper's
cross-attention), plus ``embed``, ``final_norm``, ``head`` when embeddings
are untied, ``frontend/proj`` for a modality stub, and whisper's
``encoder`` (stacked layers, learned ``pos``, ``final_norm``) and
``dec_pos`` (8192 learned decoder positions).

Storage, two kinds.  Serving (the default): a leaf the reference casts to
the activation dtype at every use (every matmul weight, the embedding and
position tables, the conv kernels) is stored already cast to
``cfg.dtype``, which is bit-identical to the per-call cast and halves its
bytes in bf16.  Leaves the reference reads in f32 (norm scales and
biases, RG-LRU's ``lam``, ``b_a``, ``b_i``, the sLSTM's recurrent
``r_gates`` and gate bias, the conv biases, the mLSTM's ``b_if`` and
``skip_scale``) stay in ``cfg.param_dtype``.  Training (``master=True``):
every leaf in ``cfg.param_dtype``, the reference's f32 master weights;
the model casts each at its use (``layers.matmul`` and the embedding
casts), so gradients reach the f32 copy that AdamW updates.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device

from .rglru import _C as _RGLRU_C
from .xlstm import CONV_W, MLSTM_PROJ, SLSTM_FF

Params = Dict[str, Any]

#: lecun_normal's truncated-normal correction: the std of a unit normal
#: truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978
#: leaf kinds stored in ``cfg.dtype``; every other kind stays in
#: ``cfg.param_dtype``
_ACTIVATION_KINDS = ("dense", "expert", "embed", "normal")


def _norm(cfg, lead=()) -> Params:
    p = {"scale": (lead + (cfg.d_model,), "zeros")}
    if cfg.norm_kind == "layernorm":
        p["bias"] = (lead + (cfg.d_model,), "zeros")
    return p


def _gqa(cfg, lead) -> Params:
    d, h, kh, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    return {"wq": (lead + (d, h * hd), "dense"),
            "wk": (lead + (d, kh * hd), "dense"),
            "wv": (lead + (d, kh * hd), "dense"),
            "wo": (lead + (h * hd, d), "dense")}


def _mla(cfg, lead) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dvh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {"wq_a": (lead + (d, qr), "dense"),
            "wq_b": (lead + (qr, h * (dn + dr)), "dense"),
            "wkv_a": (lead + (d, r + dr), "dense"),
            "wk_b": (lead + (r, h * dn), "dense"),
            "wv_b": (lead + (r, h * dvh), "dense"),
            "wo": (lead + (h * dvh, d), "dense"),
            "norm_kv": (lead + (r,), "zeros"),
            "norm_q": (lead + (qr,), "zeros")}


def _rglru(cfg, lead) -> Params:
    d = cfg.d_model
    w = cfg.lru_width or d
    return {"w_up_x": (lead + (d, w), "dense"),
            "w_up_gate": (lead + (d, w), "dense"),
            "conv_w": (lead + (cfg.rglru_conv_width, w), "normal"),
            "conv_b": (lead + (w,), "zeros"),
            "w_a": (lead + (w, w), "dense"),
            "b_a": (lead + (w,), "zeros"),
            "w_i": (lead + (w, w), "dense"),
            "b_i": (lead + (w,), "zeros"),
            "lam": (lead + (w,), "lam"),
            "w_down": (lead + (w, d), "dense")}


def _mlstm(cfg, lead) -> Params:
    d = cfg.d_model
    di = MLSTM_PROJ * d
    return {"w_up": (lead + (d, 2 * di), "dense"),
            "conv_w": (lead + (CONV_W, di), "normal"),
            "conv_b": (lead + (di,), "zeros"),
            "wq": (lead + (di, di), "dense"),
            "wk": (lead + (di, di), "dense"),
            "wv": (lead + (di, di), "dense"),
            "w_if": (lead + (di, 2 * cfg.n_heads), "dense"),
            "b_if": (lead + (2 * cfg.n_heads,), "b_if"),
            "skip_scale": (lead + (di,), "ones"),
            "w_down": (lead + (di, d), "dense")}


def _slstm(cfg, lead) -> Params:
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    f_ff = int(SLSTM_FF * d)
    return {"conv_w": (lead + (CONV_W, d), "normal"),
            "conv_b": (lead + (d,), "zeros"),
            "w_gates": (lead + (d, 4 * d), "dense"),
            "r_gates": (lead + (nh, hd, 4 * hd), "orthogonal"),
            "b_gates": (lead + (4 * d,), "zeros"),
            "ff_up": (lead + (d, 2 * f_ff), "dense"),
            "ff_down": (lead + (f_ff, d), "dense")}


def _mlp(cfg, lead) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    names = (("wi_gate", "wi_up") if cfg.mlp_kind in ("swiglu", "geglu")
             else ("wi",))
    p = {n: (lead + (d, f), "dense") for n in names}
    p["wo"] = (lead + (f, d), "dense")
    return p


def _moe(cfg, lead) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": (lead + (d, e), "dense"),
         "wi_gate": (lead + (e, d, f), "expert"),
         "wi_up": (lead + (e, d, f), "expert"),
         "wo": (lead + (e, f, d), "expert")}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"wi_gate": (lead + (d, fs), "dense"),
                       "wi_up": (lead + (d, fs), "dense"),
                       "wo": (lead + (fs, d), "dense")}
    return p


_MIXES = {"attn": None, "local_attn": None, "swa": None, "rglru": _rglru,
          "mlstm": _mlstm, "slstm": _slstm}


def _block(cfg, kind: str, lead) -> Params:
    if kind not in _MIXES:
        raise ValueError(f"unknown block kind {kind!r}")
    mix = _MIXES[kind] or (_mla if cfg.use_mla else _gqa)
    p: Params = {"norm_mix": _norm(cfg, lead), "mix": mix(cfg, lead)}
    if cfg.d_ff > 0 and cfg.mlp_kind != "none":
        p["norm_mlp"] = _norm(cfg, lead)
        p["mlp"] = _moe(cfg, lead) if cfg.is_moe else _mlp(cfg, lead)
    if cfg.is_encoder_decoder:
        p["norm_cross"] = _norm(cfg, lead)
        p["cross"] = _gqa(cfg, lead)
    return p


def _shapes(cfg) -> Params:
    """The parameter tree as nested dicts of (shape, kind) leaves.  Kinds:
    ``dense`` (lecun normal, fan-in shape[-2]), ``expert`` (lecun normal
    over an (E, in, out) expert stack, fan-in E * in as the reference's
    ``dense_init`` reckons it), ``embed`` (unit normal), ``normal`` (std
    0.02), ``zeros``, ``ones``, ``lam`` (RG-LRU decays), ``b_if`` (mLSTM
    gate biases: zeros then threes), ``orthogonal`` (per group)."""
    d, v = cfg.d_model, cfg.vocab_size
    lead = (cfg.n_groups,)
    tree: Params = {
        "embed": {"table": ((v, d), "embed")},
        "groups": {f"b{j}_{kind}": _block(cfg, kind, lead)
                   for j, kind in enumerate(cfg.block_pattern)},
        "final_norm": _norm(cfg),
    }
    if not cfg.tie_embeddings:
        tree["head"] = {"kernel": ((d, v), "dense")}
    if cfg.frontend:
        tree["frontend"] = {"proj": ((d, d), "dense")}
    if cfg.is_encoder_decoder:
        el = (cfg.n_encoder_layers,)
        tree["encoder"] = {
            "layers": {"norm_mix": _norm(cfg, el), "mix": _gqa(cfg, el),
                       "norm_mlp": _norm(cfg, el), "mlp": _mlp(cfg, el)},
            "pos": {"pos": ((cfg.encoder_ctx, d), "normal")},
            "final_norm": _norm(cfg),
        }
        tree["dec_pos"] = {"pos": ((8192, d), "normal")}
    return tree


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def storage_dtype(cfg, kind: str, master: bool = False) -> torch.dtype:
    """A leaf's dtype: ``cfg.param_dtype`` for every leaf of the training
    storage (``master``), else ``cfg.dtype`` for the kinds cast at use."""
    if master:
        return cfg.param_dtype
    return cfg.dtype if kind in _ACTIVATION_KINDS else cfg.param_dtype


#: trailing dims drawn at once per kind (the rest are looped over);
#: vector kinds take one row at a time
_DRAWN_DIMS = {"dense": 2, "expert": 2, "embed": 2, "normal": 2,
               "orthogonal": 3}


def _draw(kind, shape, fan_in, gen, dev) -> torch.Tensor:
    """One f32 matrix (or row) of ``kind``."""
    if kind == "embed":
        return torch.empty(shape, device=dev).normal_(0.0, 1.0, generator=gen)
    if kind == "normal":
        return torch.empty(shape, device=dev).normal_(0.0, 0.02,
                                                      generator=gen)
    if kind in ("dense", "expert"):
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        out = torch.empty(shape, device=dev)
        return torch.nn.init.trunc_normal_(out, 0.0, std, -2 * std, 2 * std,
                                           generator=gen)
    if kind == "orthogonal":  # (nh, hd, 4 hd) -> one (nh * hd, 4 hd) matrix
        flat = torch.empty((math.prod(shape[:-1]), shape[-1]), device=dev)
        return torch.nn.init.orthogonal_(flat, generator=gen).view(shape)
    if kind == "lam":  # a = sigmoid(lam)^c uniform in [0.9, 0.999]
        u = torch.empty(shape, device=dev).uniform_(0.9 ** 2, 0.999 ** 2,
                                                    generator=gen)
        r = u ** (1.0 / _RGLRU_C)
        return torch.log(r / (1.0 - r))
    if kind == "b_if":
        nh = shape[-1] // 2
        return torch.cat([torch.zeros(nh, device=dev),
                          torch.full((nh,), 3.0, device=dev)])
    if kind == "ones":
        return torch.ones(shape, device=dev)
    return torch.zeros(shape, device=dev)


def init_params(cfg, generator: torch.Generator, device=None, *,
                master: bool = False) -> Params:
    """Seeded random parameters on ``device`` (default CUDA), in the
    serving storage or, with ``master``, every leaf in ``param_dtype``.

    The distributions are the reference's (lecun-normal dense weights,
    unit-normal embedding, std-0.02 conv kernels and position tables, zero
    norms and biases, RG-LRU decays uniform in [0.9, 0.999], orthogonal
    sLSTM recurrences); the numbers differ from ``jax.random``'s.
    ``generator`` must live on ``device``.  Leaves are drawn one matrix at
    a time in f32 (one layer's, one expert's), so the f32 scratch is one
    matrix even for a full-width MoE stack.
    """
    dev = resolve_device(device)

    def leaf(path, spec):
        shape, kind = spec
        out = torch.empty(shape, dtype=storage_dtype(cfg, kind, master),
                          device=dev)
        inner = shape[-_DRAWN_DIMS.get(kind, 1):]
        fan_in = math.prod(shape[-3:-1] if kind == "expert" else shape[-2:-1])
        rows = out.view(-1, *inner)
        for i in range(rows.shape[0]):
            rows[i].copy_(_draw(kind, inner, fan_in, generator, dev))
        return out

    return _map(_shapes(cfg), leaf)


def from_jax_params(cfg, tree: Params, device=None, *,
                    master: bool = False) -> Params:
    """Carry a reference parameter pytree (nested dicts of NumPy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) onto ``device`` (default CUDA),
    with the same keys, shapes and storage dtypes as :func:`init_params`
    (``master``: every leaf in ``param_dtype``)."""
    dev = resolve_device(device)

    def leaf(path, spec):
        shape, kind = spec
        node = tree
        for k in path:
            node = node[k]
        arr = np.asarray(node)
        if arr.shape != shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                             f"expected {shape}")
        return torch.from_numpy(arr.astype(np.float32)).to(
            dev, storage_dtype(cfg, kind, master))

    return _map(_shapes(cfg), leaf)
