"""Mixture-of-Experts with sort-based capacity dispatch
(``repro.models.moe``).

router logits (an f32 product) -> top_k -> flatten (token, expert)
assignments -> stable argsort by expert id -> position within the expert's
run -> gather tokens into an (E, C, d) buffer (overflow past the capacity
dropped) -> batched expert matmuls (``torch.bmm`` over E) -> un-permute to
(T, k, d), weight by the router probabilities and sum over k.

The three expert products are f32 products of operands in the activation
dtype, as with the reference's default ``preferred_element_type=f32``
(:154-162): silu runs on the unrounded gate and up products, their gated
product is rounded to the activation dtype before the down projection,
and the down projection once after it.

Dispatch runs in G groups of the batch, G the data-parallel degree of the
installed mesh (``_dispatch_groups``), as in the reference; without a mesh
G is 1, the global dispatch.  On a mesh each rank runs the routing, the
sort and the dispatch and combine gathers and scatters on its own groups
only, with plain local ops inside ``local_map`` (``sharding.axes.per_rows``),
and the expert products run on DTensors in the expert-parallel layout:
the reshards between the two layouts are the layer's collectives.  The
combine sums each token's k outputs in a fixed order (no ``index_add_``,
which adds in an unordered way on CUDA), so greedy runs repeat exactly on
the card.  Every expert gets a buffer of at least 8 slots, so even a
decode step reads every expert's weights, as the reference's does.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.axes import logical_constraint, per_rows

from .layers import matmul, matmul_f32

MOE_AXES = {
    "router": ("embed", "expert"),
    "wi_gate": ("expert", "embed", "expert_mlp"),
    "wi_up": ("expert", "embed", "expert_mlp"),
    "wo": ("expert", "expert_mlp", "embed"),
    "shared": {
        "wi_gate": ("embed", "mlp"),
        "wi_up": ("embed", "mlp"),
        "wo": ("mlp", "embed"),
    },
}


def capacity_for(cfg, tokens: int, capacity: Optional[int] = None) -> int:
    """Slots per expert for ``tokens`` tokens (the reference's :107-110):
    ``int(capacity_factor * T * k / E)`` rounded up to a multiple of 8
    with a floor of 8, unless given, then at most T * k."""
    e, k = cfg.n_experts, cfg.top_k
    if capacity is None:
        capacity = int(cfg.capacity_factor * tokens * k / e)
        capacity = max(8, -(-capacity // 8) * 8)
    return min(capacity, tokens * k)


def route(cfg, p, xf: torch.Tensor):
    """Router of tokens xf (..., T, d): (f32 logits (..., T, E),
    renormalized top-k weights (..., T, k), top-k expert ids (..., T, k))."""
    logits = matmul_f32(xf, p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    return logits, top_p / top_p.sum(-1, keepdim=True), top_e


def assign(top_e: torch.Tensor, n_experts: int, capacity: int):
    """Dispatch of the (..., Tl, k) expert choices of each group (leading
    dims: groups, none for one): ``order`` sorts a group's flattened
    assignments stably by expert, ``slot`` is each sorted assignment's row
    of the group's (E * C) buffer (``E * C``, a dropped row, past the
    capacity) and ``keep`` marks the kept ones; each (..., Tl * k)."""
    flat_e = top_e.reshape(*top_e.shape[:-2], -1)
    al = flat_e.shape[-1]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    # position within the expert's run = index - first index of the expert
    first = torch.searchsorted(se, se, side="left")
    pos_in_e = torch.arange(al, device=se.device) - first
    keep = pos_in_e < capacity
    slot = torch.where(keep, se * capacity + pos_in_e,
                       torch.full_like(se, n_experts * capacity))
    return order, slot, keep


def bmm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w batched, an f32 product of a and w cast to a's dtype: bf16
    operands enter exactly and accumulate in f32, and the output is not
    rounded (on the card a bf16 GEMM with f32 output)."""
    w = w.to(a.dtype)
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a.float(), w.float())


def _experts_f32(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each group's per-expert rows through its expert: buf (G, E, C, in)
    and w (E, in, out) -> (G, E, C, out), f32 products (``bmm_f32`` over
    the experts, the groups' rows side by side)."""
    g, e, c, _ = buf.shape
    rows = buf.transpose(0, 1).reshape(e, g * c, buf.shape[3])
    out = bmm_f32(rows, w)
    return out.reshape(e, g, c, out.shape[2]).transpose(0, 1)


def _dispatch_groups(t: int) -> int:
    """Group-local dispatch width = DP degree of the installed mesh (the
    reference's :63-84): dispatch (sort, capacity, gather/scatter) runs
    independently per data-parallel group; with no mesh installed it is
    1 and the math is the global dispatch."""
    from repro_torch.sharding.axes import DEFAULT_RULES, current_mesh, \
        mesh_axes

    mesh = current_mesh()
    if mesh is None:
        return 1
    shape = mesh_axes(mesh)
    for cand in DEFAULT_RULES["batch"]:
        axes = cand if isinstance(cand, tuple) else (cand,)
        size = 1
        for a in axes:
            size *= shape.get(a, 1)
        if size > 1 and t % size == 0:
            return size
    return 1


def _dispatch(cfg, capacity: int, xf: torch.Tensor, router: torch.Tensor):
    """One rank's groups xf (g, Tl, d) into their (g, E, C, d) dispatch
    buffer: routing, the stable sort and the dispatch gather and scatter.
    Returns (buf, order, slot, keep, sw), the last four (g, Tl * k): the
    sorted assignments, their buffer rows, which are kept, and their
    router weights."""
    g, _, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    gi = torch.arange(g, device=xf.device)[:, None]
    _, top_p, top_e = route(cfg, {"router": router}, xf)
    order, slot, keep = assign(top_e, e, capacity)
    st = torch.div(order, k, rounding_mode="floor")  # token of each
    sw = torch.gather(top_p.reshape(g, -1), 1, order)
    # dropped rows all land on the spare last row, which is cut off
    # (equal-valued duplicates never matter)
    buf = xf.new_zeros((g, e * capacity + 1, d))
    buf[gi, slot] = xf[gi, st]
    return buf[:, :-1].reshape(g, e, capacity, d), order, slot, keep, sw


def _combine(k: int, out_buf: torch.Tensor, order: torch.Tensor,
             slot: torch.Tensor, keep: torch.Tensor,
             sw: torch.Tensor) -> torch.Tensor:
    """One rank's expert outputs out_buf (g, E, C, d) back to its tokens
    (g, Tl, d): gather each sorted assignment's row, weight it, un-permute
    to (g, Tl, k, d) and sum over k."""
    g, e, c, d = out_buf.shape
    gi = torch.arange(g, device=out_buf.device)[:, None]
    flat_out = out_buf.reshape(g, e * c, d)
    gathered = flat_out[gi, torch.clamp(slot, max=e * c - 1)]
    wdt = out_buf.dtype
    gathered = torch.where(keep[..., None], gathered * sw[..., None].to(wdt),
                           torch.zeros((), dtype=wdt, device=out_buf.device))
    per_choice = torch.empty_like(gathered)
    per_choice[gi, order] = gathered
    return per_choice.reshape(g, -1, k, d).sum(dim=2)


def apply_moe(cfg, p, x: torch.Tensor,
              capacity: Optional[int] = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Group-local sort-based capacity dispatch
    in G groups (:func:`_dispatch_groups`) of Tl = B * S / G tokens."""
    b, s, d = x.shape
    t = b * s
    g = _dispatch_groups(t)
    xf = logical_constraint(x.reshape(g, t // g, d), ("batch", None, "embed"))
    capacity = capacity_for(cfg, t // g, capacity)

    # built data-local (each rank its own groups), then resharded to the
    # expert-parallel layout
    buf, order, slot, keep, sw = per_rows(
        functools.partial(_dispatch, cfg, capacity), xf, xf, p["router"],
        summed=(1,), n_out=5)
    buf = logical_constraint(buf, ("batch", None, None, "embed"))
    buf = logical_constraint(buf, ("batch", "expert", None, "embed"))

    # batched expert FFN (swiglu): f32 products, the gated product and the
    # down projection rounded to the activation dtype
    wdt = x.dtype
    h = (F.silu(_experts_f32(buf, p["wi_gate"]))
         * _experts_f32(buf, p["wi_up"])).to(wdt)
    h = logical_constraint(h, ("batch", "expert", None, "expert_mlp"))
    out_buf = _experts_f32(h, p["wo"]).to(wdt)
    out_buf = logical_constraint(out_buf, ("batch", "expert", None, "embed"))

    # combine: back to data-local, then each rank its own groups
    out_buf = logical_constraint(out_buf, ("batch", None, None, "embed"))
    out = per_rows(functools.partial(_combine, cfg.top_k), xf, out_buf,
                       order, slot, keep, sw)
    out = logical_constraint(out, ("batch", None, "embed"))

    if cfg.n_shared_experts:
        sp = p["shared"]
        hs = F.silu(matmul(xf, sp["wi_gate"])) * matmul(xf, sp["wi_up"])
        out = out + matmul(hs, sp["wo"])

    out = out.reshape(b, s, d)
    return logical_constraint(out, ("batch", "seq", "embed"))


def router_aux_loss(cfg, logits: torch.Tensor,
                    top_e: torch.Tensor) -> torch.Tensor:
    """Standard load-balance auxiliary loss (Switch-style)."""
    e = cfg.n_experts
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)  # mean router prob per expert
    ce = F.one_hot(top_e.long(), e).float().sum(1).mean(dim=0) / cfg.top_k
    return e * torch.sum(me * ce)
