"""Plain PyTorch reference of a dense GQA decoder, in float32 with TF32
off, written from the configuration file and independent of the port: it
imports nothing of ``repro_torch`` and reads only the weights the
benchmark made (``weights.py``).

What it computes is the configuration as run (``arch`` in the config
file): pre-norm blocks, LayerNorm ``(x - mean) / sqrt(var + eps) * (1 +
scale) + bias`` (RMSNorm ``x / rms * (1 + scale)``), bias-free q/k/v/o
projections, rotary embedding over the whole head in split halves
(``rope_theta``), causal softmax attention at scale 1/sqrt(head_dim) with
query head h reading kv head h // (H / KH), a SwiGLU or tanh-GELU MLP,
a final norm and an untied head.  The config file lists where this
departs from the published model.

``quant="fp8"`` is the control: every matrix product takes its operands
rounded to float8 e4m3 (weights per output column, activations per row,
each scaled by its absolute maximum over 448), the nearest precision below
the configuration's bf16.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 under a scale of its absolute maximum along
    ``dim``, returned in f32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    w = w.float()
    if quant == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    return x @ w


def _norm(arch: dict, x: torch.Tensor, scale, bias, eps: float):
    if arch["norm_kind"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * (1.0 + scale.float()) \
            + bias.float()
    var = x.square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale.float())


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, hd) rotated in split halves by position."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = pos.float()[:, None] * inv  # (T, hd/2)
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _NoTF32:
    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.prev
        return False


def layer_params(params: dict, l: int) -> dict:
    """Layer ``l``'s leaves of the stacked tree (views)."""
    blk = params["groups"]["b0_attn"]
    return {part: {k: v[l] for k, v in blk[part].items()} for part in blk}


def _layer(arch: dict, p: dict, x, pos, causal, eps, quant):
    t = x.shape[0]
    h, kh = arch["n_heads"], arch["n_kv_heads"]
    hd = arch.get("head_dim") or arch["d_model"] // h
    g = h // kh
    nm, mix, nf = p["norm_mix"], p["mix"], p["norm_mlp"]
    hn = _norm(arch, x, nm["scale"], nm.get("bias"), eps)
    q = _mm(hn, mix["wq"], quant).view(t, h, hd)
    k = _mm(hn, mix["wk"], quant).view(t, kh, hd)
    v = _mm(hn, mix["wv"], quant).view(t, kh, hd)
    if arch.get("use_rope", True):
        q = _rope(q, pos, arch["rope_theta"])
        k = _rope(k, pos, arch["rope_theta"])
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    outs = []
    for h0 in range(0, h, 8):  # heads in groups: bounded score memory
        sc = torch.einsum("qhd,khd->hqk", q[:, h0:h0 + 8],
                          k[:, h0:h0 + 8]) / math.sqrt(hd)
        sc = sc.masked_fill(~causal, float("-inf")).softmax(-1)
        outs.append(torch.einsum("hqk,khd->qhd", sc, v[:, h0:h0 + 8]))
    out = torch.cat(outs, dim=1)
    x = x + _mm(out.reshape(t, h * hd), mix["wo"], quant)
    hn = _norm(arch, x, nf["scale"], nf.get("bias"), eps)
    return x + _mlp(arch, p["mlp"], hn, quant)


def _mlp(arch: dict, p: dict, h: torch.Tensor, quant) -> torch.Tensor:
    if arch["mlp_kind"] in ("swiglu", "geglu"):
        gate = _mm(h, p["wi_gate"], quant)
        gate = (F.silu(gate) if arch["mlp_kind"] == "swiglu"
                else F.gelu(gate, approximate="tanh"))
        inner = gate * _mm(h, p["wi_up"], quant)
    else:
        inner = F.gelu(_mm(h, p["wi"], quant), approximate="tanh")
    return _mm(inner, p["wo"], quant)


def hidden(arch: dict, table, layers, ids, eps: float, quant=None,
           remat: bool = False):
    """The residual stream after every layer, (T, d) f32; ``layers`` holds
    each layer's leaves (``layer_params``).  ``remat`` recomputes each
    layer in the backward instead of keeping its activations."""
    t = ids.numel()
    dev = ids.device
    pos = torch.arange(t, device=dev)
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    x = table[ids].float()
    for p in layers:
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer, arch, p, x, pos, causal, eps, quant,
                use_reentrant=False)
        else:
            x = _layer(arch, p, x, pos, causal, eps, quant)
    return x


def head_logits(arch: dict, params: dict, x, eps: float, quant=None):
    fin = params["final_norm"]
    x = _norm(arch, x, fin["scale"], fin.get("bias"), eps)
    return _mm(x, params["head"]["kernel"], quant)


@torch.no_grad()
def logits_at(arch: dict, params: dict, tokens: Sequence[int],
              at: Sequence[int], *, eps: float,
              quant: Optional[str] = None) -> torch.Tensor:
    """f32 logits (len(at), V) of the causal model over ``tokens`` at the
    positions ``at``: row i scores the token that follows ``tokens[at[i]]``.
    One sequence, layer by layer."""
    table = params["embed"]["table"]
    dev = table.device
    ids = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    layers = [layer_params(params, l) for l in range(arch["n_layers"])]
    with _NoTF32():
        x = hidden(arch, table, layers, ids, eps, quant)
        sel = x[torch.as_tensor(list(at), dtype=torch.long, device=dev)]
        return head_logits(arch, params, sel, eps, quant)


# ------------------------------------------------------------- training
def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_ratio`` of ``lr``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    r = opt["min_lr_ratio"]
    return opt["lr"] * warm * (r + (1 - r) * cos)


def _flat(tree: dict, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def train_steps(arch: dict, params0: dict, batches, opt: dict, *,
                eps: float, microbatches: int, quant: Optional[str] = None,
                used_microbatches: Optional[int] = None, steps: int = 3
                ) -> dict:
    """``steps`` training steps of the reference from ``params0`` (f32,
    the stacked tree, left as it is) on ``batches`` (dicts of ``tokens``
    and ``labels``, (B, S) arrays): each step the mean next-token
    cross-entropy of each of ``microbatches`` row groups, averaged,
    backward in f32, then AdamW with the global-norm clip, bias corrections
    and decoupled weight decay of ``opt``.  ``used_microbatches`` keeps the
    first so many groups only (a planted fault).  Returns the step losses,
    per leaf (``/``-joined path of the stacked tree) the norm of the first
    step's clipped gradient, and of the parameters' change after the
    last step."""
    dev = params0["embed"]["table"].device
    L = arch["n_layers"]
    leaves = {}
    for path, t in _flat(params0):
        parts = ([t[l] for l in range(L)] if path[0] == "groups" else [t])
        leaves[path] = [x.detach().clone().requires_grad_(True)
                        for x in parts]
    m = {p: [torch.zeros_like(x) for x in xs] for p, xs in leaves.items()}
    v = {p: [torch.zeros_like(x) for x in xs] for p, xs in leaves.items()}

    def tree_of(l=None):
        if l is None:
            return {"final_norm": {k[-1]: leaves[k][0] for k in leaves
                                   if k[0] == "final_norm"},
                    "head": {"kernel": leaves[("head", "kernel")][0]}}
        out: dict = {}
        for k, xs in leaves.items():
            if k[0] == "groups":
                out.setdefault(k[2], {})[k[3]] = xs[l]
        return out

    layers = [tree_of(l) for l in range(L)]
    top = tree_of()
    table = leaves[("embed", "table")][0]
    n_used = microbatches if used_microbatches is None else used_microbatches
    losses, grad1 = [], None
    b1, b2 = opt["beta1"], opt["beta2"]
    with _NoTF32():
        for step in range(1, steps + 1):
            batch = batches[step - 1]
            toks = torch.as_tensor(batch["tokens"], device=dev).long()
            labs = torch.as_tensor(batch["labels"], device=dev).long()
            rows = toks.shape[0] // microbatches
            total = 0.0
            for i in range(n_used):
                mb = 0.0
                for r in range(i * rows, (i + 1) * rows):
                    x = hidden(arch, table, layers, toks[r], eps, quant,
                               remat=True)
                    logits = head_logits(arch, top, x, eps, quant)
                    nll = F.cross_entropy(logits, labs[r])
                    (nll / (rows * n_used)).backward()
                    mb += float(nll.detach()) / rows
                total += mb / n_used
            losses.append(total)
            with torch.no_grad():
                gn = math.sqrt(sum(float(x.grad.square().sum())
                                   for xs in leaves.values() for x in xs))
                clip = min(opt["grad_clip"] / max(gn, 1e-12), 1.0)
                lr = lr_at(opt, step)
                bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
                if step == 1:
                    grad1 = {"/".join(k): clip * math.sqrt(sum(
                        float(x.grad.square().sum()) for x in xs))
                        for k, xs in leaves.items()}
                for k, xs in leaves.items():
                    for j, p in enumerate(xs):
                        g = p.grad * clip
                        m[k][j].mul_(b1).add_((1 - b1) * g)
                        v[k][j].mul_(b2).add_((1 - b2) * g * g)
                        delta = (m[k][j] / bc1).div_(
                            (v[k][j] / bc2).sqrt_().add_(opt["eps"]))
                        delta.add_(opt["weight_decay"] * p)
                        p.sub_(delta.mul_(lr))
                        p.grad = None
    change = {}
    with torch.no_grad():
        for path, t in _flat(params0):
            xs = leaves[path]
            parts = ([t[l] for l in range(L)] if path[0] == "groups" else [t])
            change["/".join(path)] = math.sqrt(sum(
                float((x - p0).square().sum()) for x, p0 in zip(xs, parts)))
    return {"losses": losses, "grad1": grad1, "change": change}
