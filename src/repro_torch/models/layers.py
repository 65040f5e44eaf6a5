"""Shared primitive layers: norms, embeddings, MLPs, RoPE, tree helpers.

Plain functions over tensors and a params dict, as in ``repro.models.layers``.
Matmuls cast the weight to the activation dtype; on the card a bf16 product
accumulates in f32 inside cuBLAS and rounds its output to bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.axes import is_dtensor, logical_constraint, rewrap


def matmul(x: torch.Tensor, w: torch.Tensor, dtype=None) -> torch.Tensor:
    """x @ w; contracts the last dim of x with dim 0 of w.  The output is
    cast to ``dtype`` (default: the activation dtype)."""
    out_dtype = dtype or x.dtype
    return torch.matmul(x, w.to(x.dtype)).to(out_dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as an f32 product: both operands are read as f32 after the
    weight is cast to the activation dtype, so bf16 inputs enter exactly and
    nothing rounds to bf16 (``repro``'s ``matmul(..., dtype=f32)`` with its
    f32 accumulation).  For small weights (the MoE router)."""
    return torch.matmul(x.float(), w.to(x.dtype).float())


def index_tree(tree, i):
    """The ``i``-th slice of every leaf of a nested dict (one group's or
    one layer's parameters or cache out of a stacked tree); views, no copy."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def stack_trees(trees):
    """Stack a list of nested dicts of tensors leaf by leaf (new dim 0)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ----------------------------------------------------------------- norms
def apply_norm(cfg, p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * (1.0 + p["scale"].float()) + p["bias"].float()
    else:  # rmsnorm (zero-centered scale, gemma convention)
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"].float())
    return y.to(x.dtype)


NORM_AXES = {"scale": ("embed",), "bias": ("embed",)}


# ----------------------------------------------------------------- embedding
EMBED_AXES = {"table": ("vocab", "embed")}


def embed_tokens(cfg, p, tokens: torch.Tensor) -> torch.Tensor:
    table = p["table"].to(cfg.dtype)
    if is_dtensor(table) and table.device_mesh.size() > 1:
        x = _lookup_per_shard(table, tokens)
    else:
        x = table[tokens]
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)  # gemma input scaling
    return logical_constraint(x, ("batch", "seq", "embed"))


def _lookup_per_shard(table, tokens):
    """``table[tokens]`` for a DTensor table on a mesh, vocab-parallel and
    local: the table's embed dim is gathered, each rank looks its tokens up
    in the vocab rows it holds (zero for a row another rank holds), and the
    result is ``Partial`` over the mesh dims the vocab shards on, which the
    caller's layout constraint sums.  DTensor's own rule for the gather
    (and for its gradient's scatter) differs between torch versions and
    refuses a batch sharded over two mesh dims in some."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    tokens = tokens if is_dtensor(tokens) else rewrap(tokens, mesh)
    vocab = tuple(Shard(0) if p == Shard(0) else Replicate()
                  for p in table.placements)
    rows = tuple(Shard(0) if t == Shard(0) and v != Shard(0) else Replicate()
                 for t, v in zip(tokens.placements, vocab))
    out = tuple(Partial() if v == Shard(0) else r
                for v, r in zip(vocab, rows))
    # a rank's table gradient covers its own rows' tokens: summed over the
    # mesh dims the tokens shard on
    grad = tuple(Partial() if r == Shard(0) else v
                 for v, r in zip(vocab, rows))
    _, (start, _) = compute_local_shape_and_global_offset(table.shape, mesh,
                                                          vocab)

    def local(w, tok):
        ids = tok.long() - start
        hit = (ids >= 0) & (ids < w.shape[0])
        return w[ids.clamp(0, w.shape[0] - 1)] * hit[..., None].to(w.dtype)

    return local_map(local, out_placements=(out,),
                     in_placements=(vocab, rows),
                     in_grad_placements=(grad, rows), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def unembed(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """Project to f32 vocab logits (tied or untied head)."""
    logits = matmul(x, p["table"].T if "table" in p else p["kernel"],
                    dtype=torch.float32)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logical_constraint(logits, ("batch", "seq", "vocab"))


# ----------------------------------------------------------------- MLP
MLP_AXES = {
    "wi_gate": ("embed", "mlp"),
    "wi_up": ("embed", "mlp"),
    "wi": ("embed", "mlp"),
    "wo": ("mlp", "embed"),
}


def apply_mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind in ("swiglu", "geglu"):
        gate = matmul(x, p["wi_gate"])
        gate = F.silu(gate) if cfg.mlp_kind == "swiglu" else F.gelu(
            gate, approximate="tanh")
        h = gate * matmul(x, p["wi_up"])
    else:
        h = F.gelu(matmul(x, p["wi"]), approximate="tanh")
    h = logical_constraint(h, ("batch", "seq", "mlp"))
    out = matmul(h, p["wo"])
    return logical_constraint(out, ("batch", "seq", "embed"))


# ----------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Split-half."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
