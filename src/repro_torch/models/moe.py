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

Without a mesh the reference dispatches in one group (``_dispatch_groups``
is 1), and so does the port.  The combine sums each token's k outputs in a
fixed order (no ``index_add_``, which adds in an unordered way on CUDA),
so greedy runs repeat exactly on the card.  Every expert gets a buffer of
at least 8 slots, so even a decode step reads every expert's weights, as
the reference's does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .layers import matmul, matmul_f32


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
    """Router of tokens xf (T, d): (f32 logits (T, E), renormalized top-k
    weights (T, k), top-k expert ids (T, k))."""
    logits = matmul_f32(xf, p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    return logits, top_p / top_p.sum(-1, keepdim=True), top_e


def assign(top_e: torch.Tensor, n_experts: int, capacity: int):
    """Dispatch of the (T, k) expert choices: ``order`` sorts the flattened
    assignments stably by expert, ``slot`` is each sorted assignment's row
    of the (E * C) buffer (``E * C``, a dropped row, past the capacity) and
    ``keep`` marks the kept ones."""
    al = top_e.numel()
    flat_e = top_e.reshape(al)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
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


def apply_moe(cfg, p, x: torch.Tensor,
              capacity: Optional[int] = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xf = x.reshape(t, d)
    _, top_p, top_e = route(cfg, p, xf)
    capacity = capacity_for(cfg, t, capacity)
    order, slot, keep = assign(top_e, e, capacity)
    st = torch.div(order, k, rounding_mode="floor")  # token of each
    sw = top_p.reshape(-1)[order]

    # the (E, C, d) dispatch buffer; dropped rows all land on the spare
    # last row, which is cut off (equal-valued duplicates never matter)
    buf = x.new_zeros((e * capacity + 1, d))
    buf[slot] = xf[st]
    buf = buf[:-1].reshape(e, capacity, d)

    # batched expert FFN (swiglu): f32 products, the gated product and the
    # down projection rounded to the activation dtype
    wdt = x.dtype
    h = (F.silu(bmm_f32(buf, p["wi_gate"]))
         * bmm_f32(buf, p["wi_up"])).to(wdt)
    out_buf = bmm_f32(h, p["wo"]).to(wdt).reshape(e * capacity, d)

    # combine: gather each sorted assignment's row, weight it, un-permute
    # to (T, k, d) and sum over k
    gathered = out_buf[torch.clamp(slot, max=e * capacity - 1)]
    gathered = torch.where(keep[:, None], gathered * sw[:, None].to(wdt),
                           torch.zeros((), dtype=wdt, device=x.device))
    per_choice = torch.empty_like(gathered)
    per_choice[order] = gathered
    out = per_choice.reshape(t, k, d).sum(dim=1)

    if cfg.n_shared_experts:
        sp = p["shared"]
        hs = F.silu(matmul(xf, sp["wi_gate"])) * matmul(xf, sp["wi_up"])
        out = out + matmul(hs, sp["wo"])
    return out.reshape(b, s, d)


def router_aux_loss(cfg, logits: torch.Tensor,
                    top_e: torch.Tensor) -> torch.Tensor:
    """Standard load-balance auxiliary loss (Switch-style)."""
    e = cfg.n_experts
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)  # mean router prob per expert
    ce = F.one_hot(top_e.long(), e).float().sum(1).mean(dim=0) / cfg.top_k
    return e * torch.sum(me * ce)
