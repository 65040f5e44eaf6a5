"""RG-LRU recurrent block (RecurrentGemma / Griffin), ``repro.models.rglru``.

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = exp(c * r_t * log(sigmoid(Λ)))  (elementwise decay, c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Train and prefill run the diagonal linear recurrence as a doubling
(Hillis-Steele) scan over T in log2(T) steps; the reference's
``associative_scan`` combines in another order, so the two agree to f32
rounding, not bitwise.  Decode is an O(1) state update.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.sharding.axes import logical_constraint, on_replicated

from .layers import matmul

_C = 8.0  # decay sharpness constant from the Griffin paper

RGLRU_AXES = {
    "w_up_x": ("embed", "mlp"),
    "w_up_gate": ("embed", "mlp"),
    "conv_w": ("conv", "mlp"),
    "conv_b": ("mlp",),
    "w_a": ("mlp", None),
    "b_a": ("mlp",),
    "w_i": ("mlp", None),
    "b_i": ("mlp",),
    "lam": ("mlp",),
    "w_down": ("mlp", "embed"),
}


def causal_conv(p, x: torch.Tensor, state: torch.Tensor = None):
    """Width-W causal depthwise conv over time.  x: (B, T, w); with
    ``state`` (B, W-1, w) the decode form.  Returns (out, new tail)."""
    kw = p["conv_w"].shape[0]
    w = p["conv_w"].to(x.dtype)
    full = (torch.cat([state, x], dim=1) if state is not None
            else F.pad(x, (0, 0, kw - 1, 0)))
    t = x.shape[1]
    out = sum(full[:, i:i + t] * w[i] for i in range(kw))
    return out + p["conv_b"].to(x.dtype), full[:, -(kw - 1):]


def _gates(p, xc: torch.Tensor):
    r = torch.sigmoid(matmul(xc, p["w_a"], dtype=torch.float32)
                      + p["b_a"].float())
    i = torch.sigmoid(matmul(xc, p["w_i"], dtype=torch.float32)
                      + p["b_i"].float())
    # log_sigmoid's backward has no DTensor sharding rule
    log_a = _C * r * on_replicated(F.logsigmoid, p["lam"].float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, beta * i * xc.float()


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, by doubling:
    after the step at offset o each element holds the composition of the
    2o elements ending at it."""
    t, off = a.shape[1], 1
    while off < t:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return b


def rglru_train(cfg, p, x: torch.Tensor, return_state: bool = False):
    """x: (B, T, d) -> (B, T, d); with ``return_state`` also the decode
    state after the last token."""
    gate = F.gelu(matmul(x, p["w_up_gate"]), approximate="tanh")
    xb = matmul(x, p["w_up_x"])
    xc, conv_tail = causal_conv(p, xb)
    a, b = _gates(p, xc)  # (B, T, w) f32 each
    hf = linear_scan(a, b)
    h = logical_constraint(hf.to(x.dtype), ("batch", "seq", "mlp"))
    out = matmul(h * gate, p["w_down"])
    out = logical_constraint(out, ("batch", "seq", "embed"))
    if return_state:
        return out, {"h": hf[:, -1], "conv": conv_tail}
    return out


def init_rglru_state(cfg, batch: int, dtype=torch.float32, device=None):
    w = cfg.lru_width or cfg.d_model
    dev = resolve_device(device)
    return {"h": torch.zeros((batch, w), device=dev),
            "conv": torch.zeros((batch, cfg.rglru_conv_width - 1, w),
                                dtype=dtype, device=dev)}


RGLRU_STATE_AXES = {"h": ("batch", "mlp"), "conv": ("batch", None, "mlp")}


def rglru_decode(cfg, p, x: torch.Tensor, state) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d); O(1) state update."""
    gate = F.gelu(matmul(x, p["w_up_gate"]), approximate="tanh")
    xb = matmul(x, p["w_up_x"])
    xc, conv_state = causal_conv(p, xb, state["conv"])
    a, b = _gates(p, xc)  # (B, 1, w)
    h = a[:, 0] * state["h"] + b[:, 0]
    out = matmul(h[:, None].to(x.dtype) * gate, p["w_down"])
    return out, {"h": h, "conv": conv_state}
