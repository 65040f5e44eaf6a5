"""Shared primitive layers: norms, embeddings, MLPs, RoPE, tree helpers.

Plain functions over tensors and a params dict, as in ``repro.models.layers``.
Matmuls cast the weight to the activation dtype and follow the reference's
rule for the product's precision (:func:`matmul`).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.sharding.axes import is_dtensor, logical_constraint, rewrap

from . import perf_flags


def matmul(x: torch.Tensor, w: torch.Tensor, dtype=None) -> torch.Tensor:
    """x @ w; contracts the last dim of x with dim 0 of w.  The output is
    cast to ``dtype`` (default: the activation dtype).

    As the reference's dot with ``preferred_element_type=f32``, the
    product is an f32 product of x and the weight cast to x's dtype, cast
    once to the output dtype: an explicit ``dtype`` other than x's gets
    the unrounded product.  On a mesh of more than one device a bf16 (or
    f16) product runs shard by shard (:func:`product`), and the partial
    sums of a sharded contraction, forward and backward, are summed in
    f32 and rounded once; under ``perf_flags.bf16_collective_matmul`` and
    with no explicit ``dtype`` each shard's product is rounded to the
    activation dtype and the partials are summed in it, as the reference's
    toggle does.  Off a mesh a call with no explicit ``dtype`` is a plain
    product: one rounding of an f32-accumulated product either way."""
    out_dtype = dtype or x.dtype
    w = w.to(x.dtype)
    if out_dtype != x.dtype:
        return product(x, w, out_dtype)
    if x.dtype == torch.float32 or not _on_mesh(x, w):
        return torch.matmul(x, w)
    bf16 = perf_flags.FLAGS["bf16_collective_matmul"] and dtype is None
    return product(x, w, out_dtype, acc=x.dtype if bf16 else None)


def _on_mesh(*xs) -> bool:
    return any(is_dtensor(x) and x.device_mesh.size() > 1 for x in xs)


def _gemm(a: torch.Tensor, b: torch.Tensor, acc: torch.dtype):
    """a @ b (2-D, or batched 3-D) on local tensors, its output in
    ``acc``.  For an f32 output of bf16/f16 operands: on the card (and on
    meta tensors, which stand for it) a GEMM with f32 output, an f32
    operand (a cotangent) entering it rounded to the other's dtype, as the
    port's bf16 GEMMs always took it (an f32 GEMM of the upcast operands
    runs at the f32 rate, 1/15 of bf16's); elsewhere the f32 product of
    the upcast operands."""
    op = torch.bmm if a.ndim == 3 else torch.mm
    low = next((t.dtype for t in (a, b) if t.dtype != torch.float32), None)
    if acc != torch.float32:
        return op(a.to(acc), b.to(acc))
    if low is not None and a.device.type in ("cuda", "meta"):
        return op(a.to(low), b.to(low), out_dtype=torch.float32)
    return op(a.float(), b.float())


# The local products of :func:`product`, forward and gradients, each with
# the roles of its operands' dims: ("k", i) the i-th contracted dim, ("o", j)
# the output's dim j (a dim both operands carry, the experts', has the same
# role in each).
def _mm(a, w, acc):
    """a (..., K) @ w (K, N) -> (..., N)."""
    return _gemm(a.reshape(-1, a.shape[-1]), w, acc).reshape(
        *a.shape[:-1], w.shape[1])


def _mm_dx(g, w, acc):
    """g (..., N) @ w.T for w (K, N) -> (..., K)."""
    return _gemm(g.reshape(-1, g.shape[-1]), w.T, acc).reshape(
        *g.shape[:-1], w.shape[0])


def _mm_dw(a, g, acc):
    """a (..., K), g (..., N) -> a^T g (K, N), summed over every row."""
    return _gemm(a.reshape(-1, a.shape[-1]).T, g.reshape(-1, g.shape[-1]),
                 acc)


def _mm_products(nd):
    """(local fn, (a's roles, b's roles)) of the forward, dx and dw of a
    product whose activation has ``nd`` dims."""
    rows = tuple(("o", i) for i in range(nd - 1))
    summed = tuple(("k", i) for i in range(nd - 1))
    return ((_mm, (rows + (("k", 0),), (("k", 0), ("o", nd - 1)))),
            (_mm_dx, (rows + (("k", 0),), (("o", nd - 1), ("k", 0)))),
            (_mm_dw, (summed + (("o", 0),), summed + (("o", 1),))))


def _bmm(a, b, acc):
    """a (E, M, K) @ b (E, K, N) -> (E, M, N)."""
    return _gemm(a, b, acc)


def _bmm_dx(g, b, acc):
    return _gemm(g, b.transpose(1, 2), acc)


def _bmm_dw(a, g, acc):
    return _gemm(a.transpose(1, 2), g, acc)


_BMM_PRODUCTS = ((_bmm, ((("o", 0), ("o", 1), ("k", 0)),
                         (("o", 0), ("k", 0), ("o", 2)))),
                 (_bmm_dx, ((("o", 0), ("o", 1), ("k", 0)),
                            (("o", 0), ("o", 2), ("k", 0)))),
                 (_bmm_dw, ((("o", 0), ("k", 0), ("o", 1)),
                            (("o", 0), ("k", 0), ("o", 2)))))


def _role(placement, roles):
    """The role of the dim a placement shards, "p" for ``Partial``, else
    None."""
    if placement.is_shard():
        return roles[placement.dim]
    return "p" if placement.is_partial() else None


def _sharded(local, roles, a, b, acc, like=None):
    """``local(a, b, acc)`` on plain tensors, or shard by shard on DTensors
    with its partial sums reduced in ``acc``.  Per mesh dim the operands
    take the layout of the role a's placement shards (else b's): a
    contracted role shards both operands along it and leaves the output
    ``Partial``, an output role shards the output, and a ``Partial``
    operand meets a replicated one; the operands are redistributed to that
    layout.  Each rank runs ``local`` on its shards (``local_map``; DTensor
    has no rule for a product with another output dtype), then each
    ``Partial`` mesh dim is reduced to ``like``'s placement there (a
    gradient to its operand's layout: a reduce-scatter where the operand
    is sharded, as an FSDP weight's is over "data"), else all-reduced to
    ``Replicate()``."""
    if not (is_dtensor(a) or is_dtensor(b)):
        return local(a, b, acc)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = (a if is_dtensor(a) else b).device_mesh
    a, b = (t if is_dtensor(t) else rewrap(t, mesh) for t in (a, b))
    ra, rb = roles
    pa, pb, po = [], [], []
    for qa, qb in zip(a.placements, b.placements):
        take = _role(qa, ra) or _role(qb, rb)
        if take == "p":
            pa.append(qa if qa.is_partial() else Replicate())
            pb.append(Replicate() if qa.is_partial() else qb)
            po.append(Partial((qa if qa.is_partial() else qb).reduce_op))
            continue
        pa.append(Shard(ra.index(take)) if take in ra else Replicate())
        pb.append(Shard(rb.index(take)) if take in rb else Replicate())
        po.append(Replicate() if take is None else Partial()
                  if take[0] == "k" else Shard(take[1]))
    out = local_map(functools.partial(local, acc=acc),
                    out_placements=(tuple(po),),
                    in_placements=(tuple(pa), tuple(pb)), device_mesh=mesh,
                    redistribute_inputs=True)(a, b)
    if any(p.is_partial() for p in po):
        keep = (like.placements if is_dtensor(like) and like.ndim == out.ndim
                else [Replicate()] * len(po))
        out = out.redistribute(mesh, [
            (k if k.is_shard() else Replicate()) if p.is_partial() else p
            for p, k in zip(po, keep)])
    return out


class _Product(torch.autograd.Function):
    """x @ w, or batched x (E, M, K) @ w (E, K, N), with its output and its
    partial sums in ``acc``, cast to ``out_dtype``; the gradients are
    products of the same kind, each cast once to its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w, out_dtype, acc, batched):
        ctx.save_for_backward(x, w)
        ctx.acc = acc
        ctx.products = _BMM_PRODUCTS if batched else _mm_products(x.ndim)
        return _sharded(*ctx.products[0], x, w, acc).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        _, dx_of, dw_of = ctx.products
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _sharded(*dx_of, g, w, ctx.acc, like=x).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _sharded(*dw_of, x, g, ctx.acc, like=w).to(w.dtype)
        return dx, dw, None, None, None


def product(x: torch.Tensor, w: torch.Tensor, out_dtype=None, acc=None,
            batched: bool = False) -> torch.Tensor:
    """x @ w (``batched``: x (E, M, K) @ w (E, K, N)) of operands of one
    dtype, its output and partial sums in ``acc`` (default f32: bf16
    operands enter exactly, accumulate in f32 and nothing rounds before
    the cast), cast to ``out_dtype`` (default: ``acc``).  On DTensors it
    runs shard by shard and reduces its partial sums in ``acc``
    (:func:`_sharded`).  Differentiable: the gradients follow the same
    rule."""
    acc = acc or torch.float32
    return _Product.apply(x, w, out_dtype or acc, acc, batched)


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
