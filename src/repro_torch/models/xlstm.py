"""xLSTM blocks (``repro.models.xlstm``): mLSTM (matrix memory) and sLSTM
(scalar memory).

* The mLSTM's recurrence C_t = f_t C_{t-1} + i_t k_t v_tᵀ runs chunkwise:
  a loop over T/chunk chunks carrying the stabilized (C, n, m) state, with
  the intra-chunk part a (chunk x chunk) decay-masked attention; gating in
  log space, f32.
* The sLSTM has recurrent h -> gate connections, so it is a loop over T
  with block-diagonal (per-head) recurrent weights.  Decode is O(1) for
  both.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.sharding.axes import (flatten_last, logical_constraint,
                                       on_replicated, per_rows,
                                       unflatten_last)

from .layers import matmul
from .loops import counted_range
from .rglru import causal_conv as _conv

MLSTM_PROJ = 2  # up-projection factor (paper)
SLSTM_FF = 4.0 / 3.0  # post-cell gated FFN factor (paper)
CONV_W = 4


def _split_heads(x, nh):
    return unflatten_last(x, (nh, x.shape[-1] // nh))


# ===================================================================== mLSTM
MLSTM_AXES = {
    "w_up": ("embed", "mlp"),
    "conv_w": ("conv", "mlp"),
    "conv_b": ("mlp",),
    "wq": ("mlp", "qkv"),
    "wk": ("mlp", "qkv"),
    "wv": ("mlp", "qkv"),
    "w_if": ("mlp", None),
    "b_if": (None,),
    "skip_scale": ("mlp",),
    "w_down": ("mlp", "embed"),
}


def _mlstm_qkvif(cfg, p, x, conv_state=None):
    """Shared pre-cell computation.  x: (B, T, d)."""
    nh = cfg.n_heads
    up = matmul(x, p["w_up"])
    xm, z = up.chunk(2, dim=-1)  # mLSTM branch, output gate branch
    xc, conv_state = _conv(p, xm, conv_state)
    xc = F.silu(xc)
    q = _split_heads(matmul(xc, p["wq"]), nh)
    k = _split_heads(matmul(xc, p["wk"]), nh) / torch.tensor(
        p["wq"].shape[0] // nh, dtype=x.dtype, device=x.device).sqrt()
    v = _split_heads(matmul(xm, p["wv"]), nh)
    gif = matmul(xc, p["w_if"], dtype=torch.float32) + p["b_if"].float()
    log_i = gif[..., :nh]  # exponential input gate: i = exp(raw)
    # sigmoid forget gate; log_sigmoid's backward has no DTensor rule
    log_f = on_replicated(F.logsigmoid, gif[..., nh:])
    return q, k, v, log_i, log_f, xc, z, conv_state


def _mlstm_chunk(C, n, m_in, qi, ki, vi, li, lf, tril):
    """One chunk of the stabilized chunkwise recurrence (the reference's
    scan step).  C (B,nh,hd,hd), n (B,nh,hd), m_in (B,nh) carried state;
    qi/ki/vi (B,L,nh,hd) f32, li/lf (B,L,nh).  Returns (C, n, m, h)."""
    lf_cum = torch.cumsum(lf, dim=1)  # (B, L, nh)
    lf_total = lf_cum[:, -1]  # (B, nh)
    # true intra log-weights: lf_cum[t] - lf_cum[s] + li[s]  (s <= t)
    ldiff = (lf_cum[:, :, None, :] - lf_cum[:, None, :, :]
             + li[:, None, :, :])  # (B, L, L, nh)
    l_inter = lf_cum + m_in[:, None, :]  # true log-weight on C_true
    m_t = torch.maximum(
        torch.where(tril, ldiff, -torch.inf).amax(dim=2), l_inter)
    D = torch.where(tril, torch.exp(ldiff - m_t[:, :, None, :]), 0.0)
    inter_w = torch.exp(l_inter - m_t)  # (B, L, nh)
    s_intra = torch.einsum("blhd,bmhd->blmh", qi, ki) * D
    h_num = (torch.einsum("blmh,bmhe->blhe", s_intra, vi)
             + torch.einsum("blhd,bhde->blhe", qi, C) * inter_w[..., None])
    den = (s_intra.sum(dim=2)
           + torch.einsum("blhd,bhd->blh", qi, n) * inter_w)
    # max(|den_true|, 1) == exp(m_t)·max(|den|, exp(-m_t))
    h = h_num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # carry the state to the chunk's end (stabilized by m_out)
    m_out = torch.maximum(lf_total + m_in,
                          (lf_total[:, None] - lf_cum + li).amax(dim=1))
    dec_k = torch.exp(lf_total[:, None] - lf_cum + li - m_out[:, None])
    carry = torch.exp(lf_total + m_in - m_out)
    C_new = (carry[..., None, None] * C
             + torch.einsum("blhd,blhe->bhde", ki * dec_k[..., None], vi))
    n_new = carry[..., None] * n + (ki * dec_k[..., None]).sum(dim=1)
    return C_new, n_new, m_out, h


def mlstm_train(cfg, p, x: torch.Tensor, chunk: int = 128,
                return_state: bool = False):
    """Chunkwise mLSTM with cross-chunk log-space (m) stabilization; the
    carried state is stabilized (C_true = C·exp(m), n_true = n·exp(m))."""
    b, t, d = x.shape
    nh = cfg.n_heads
    q, k, v, log_i, log_f, xc, z, conv_tail = _mlstm_qkvif(cfg, p, x)
    hd = q.shape[-1]
    chunk = min(chunk, t)
    assert t % chunk == 0, (t, chunk)
    dev = x.device
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=dev))[None, :, :, None]
    C = torch.zeros((b, nh, hd, hd), device=dev)
    n = torch.zeros((b, nh, hd), device=dev)
    m = torch.zeros((b, nh), device=dev)
    hs = []
    for c in counted_range(t // chunk, x):
        sl = slice(c * chunk, (c + 1) * chunk)
        # each batch row's recurrence on the rank that holds the row
        C, n, m, h = per_rows(_mlstm_chunk, q, C, n, m, q[:, sl].float(),
                              k[:, sl].float(), v[:, sl].float(),
                              log_i[:, sl], log_f[:, sl], tril, n_out=4)
        hs.append(h.to(x.dtype))
    hs += hs[-1:] * (t // chunk - len(hs))  # two trips on meta tensors
    h = flatten_last(torch.cat(hs, dim=1))  # (B, T, nh * hd)
    h = h + p["skip_scale"].to(x.dtype) * xc  # learnable skip
    out = matmul(h * F.silu(z), p["w_down"])
    out = logical_constraint(out, ("batch", "seq", "embed"))
    if return_state:
        return out, {"C": C, "n": n, "m": m, "conv": conv_tail}
    return out


def init_mlstm_state(cfg, batch: int, dtype=torch.float32, device=None):
    nh = cfg.n_heads
    hd = MLSTM_PROJ * cfg.d_model // nh
    di = MLSTM_PROJ * cfg.d_model
    dev = resolve_device(device)
    return {"C": torch.zeros((batch, nh, hd, hd), device=dev),
            "n": torch.zeros((batch, nh, hd), device=dev),
            "m": torch.zeros((batch, nh), device=dev),
            "conv": torch.zeros((batch, CONV_W - 1, di), dtype=cfg.dtype,
                                device=dev)}


MLSTM_STATE_AXES = {
    "C": ("batch", "heads", None, None),
    "n": ("batch", "heads", None),
    "m": ("batch", "heads"),
    "conv": ("batch", None, "mlp"),
}


def mlstm_decode(cfg, p, x: torch.Tensor, state) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d); O(1) stabilized recurrent update."""
    q, k, v, log_i, log_f, xc, z, conv_state = _mlstm_qkvif(
        cfg, p, x, state["conv"])
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    li, lf = log_i[:, 0], log_f[:, 0]  # (B, nh)
    m_new = torch.maximum(lf + state["m"], li)
    i = torch.exp(li - m_new)
    f = torch.exp(lf + state["m"] - m_new)
    C = f[..., None, None] * state["C"] + i[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", k, v)
    n = f[..., None] * state["n"] + i[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(x.shape[0], 1, -1).to(x.dtype)
    h = h + p["skip_scale"].to(x.dtype) * xc
    out = matmul(h * F.silu(z), p["w_down"])
    return out, {"C": C, "n": n, "m": m_new, "conv": conv_state}


# ===================================================================== sLSTM
SLSTM_AXES = {
    "conv_w": ("conv", "embed"),
    "conv_b": ("embed",),
    "w_gates": ("embed", None),
    "r_gates": ("heads", "head_dim", None),
    "b_gates": (None,),
    "ff_up": ("embed", "mlp"),
    "ff_down": ("mlp", "embed"),
}


def _slstm_cell(cfg, p, gx, state):
    """One recurrence step.  gx: (B, 4d) input-gate preactivations."""
    nh = cfg.n_heads
    b = gx.shape[0]
    hd = cfg.d_model // nh
    c, n, h, m = state  # each (B, d) f32
    gr = torch.einsum("bhd,hde->bhe", h.reshape(b, nh, hd),
                      p["r_gates"].float())
    g = gx + gr.reshape(b, 4 * cfg.d_model) + p["b_gates"].float()
    gi, gf, gz, go = g.chunk(4, dim=-1)
    # stabilized exponential gating
    log_f = on_replicated(F.logsigmoid, gf)
    m_new = torch.maximum(log_f + m, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(log_f + m - m_new)
    c_new = f * c + i * torch.tanh(gz)
    n_new = f * n + i
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new.abs(), min=1.0)
    return c_new, n_new, h_new, m_new


def _slstm_ff(p, hb):
    u, g = matmul(hb, p["ff_up"]).chunk(2, dim=-1)
    return matmul(u * F.gelu(g, approximate="tanh"), p["ff_down"])


def slstm_train(cfg, p, x: torch.Tensor, return_state: bool = False):
    """x: (B, T, d); a loop over T (a true recurrence)."""
    b, t, d = x.shape
    xc, conv_tail = _conv(p, x)
    gx = matmul(F.silu(xc), p["w_gates"], dtype=torch.float32)  # (B, T, 4d)
    zeros = torch.zeros((b, d), device=x.device)
    st = (zeros, zeros, zeros, torch.full((b, d), -1e30, device=x.device))
    def cell(g, c, n, h, m, r_gates, b_gates):
        return _slstm_cell(cfg, {"r_gates": r_gates, "b_gates": b_gates}, g,
                           (c, n, h, m))

    hs = []
    for i in counted_range(t, x):
        # each batch row's step on the rank that holds the row
        st = per_rows(cell, gx, gx[:, i], *st, p["r_gates"], p["b_gates"],
                      summed=(5, 6), n_out=4)
        hs.append(st[2])
    hs += hs[-1:] * (t - len(hs))  # two trips on meta tensors
    out = _slstm_ff(p, torch.stack(hs, dim=1).to(x.dtype))
    out = logical_constraint(out, ("batch", "seq", "embed"))
    if return_state:
        cf, nf, hf, mf = st
        return out, {"c": cf, "n": nf, "h": hf, "m": mf, "conv": conv_tail}
    return out


def init_slstm_state(cfg, batch: int, dtype=torch.float32, device=None):
    d = cfg.d_model
    dev = resolve_device(device)
    return {"c": torch.zeros((batch, d), device=dev),
            "n": torch.zeros((batch, d), device=dev),
            "h": torch.zeros((batch, d), device=dev),
            "m": torch.full((batch, d), -1e30, device=dev),
            "conv": torch.zeros((batch, CONV_W - 1, d), dtype=cfg.dtype,
                                device=dev)}


def slstm_decode(cfg, p, x: torch.Tensor, state) -> Tuple[torch.Tensor, dict]:
    xc, conv_state = _conv(p, x, state["conv"])
    gx = matmul(F.silu(xc), p["w_gates"], dtype=torch.float32)[:, 0]
    st = (state["c"], state["n"], state["h"], state["m"])
    c, n, h, m = _slstm_cell(cfg, p, gx, st)
    out = _slstm_ff(p, h[:, None].to(x.dtype))
    return out, {"c": c, "n": n, "h": h, "m": m, "conv": conv_state}
