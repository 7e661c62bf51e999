"""Plain float32 reference of the served decoder family: GQA attention
(optional qkv bias, rotate-half RoPE or no positions), RMSNorm, a SwiGLU
MLP or a mixture of experts (float32 router softmax, top-k gates
renormalised, SwiGLU experts, shared experts as one SwiGLU MLP), and an
untied or tied head.  Teacher-forced over a whole sequence, no cache, no
batching, no kernel: the equations the configuration files state.

``leaves`` lists the weights a configuration needs, under the names the
served system gives its parameters, with the distribution the benchmark
draws them from.  The same tensors go to both sides.

The float32 path sets ``allow_tf32`` off.  ``control`` gives the same
forward with every matrix rounded to float8 e4m3 (a scale per output
channel): the precision a later change might be tempted to serve in.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

Leaf = Tuple[str, Tuple[int, ...], str, str, float]   # name, shape, kind, init, std


def leaves(cfg: dict) -> List[Leaf]:
    """(name, shape, kind, init, std): kind "w" is stored in the served
    dtype, "f32" in float32; init "normal" (times std), "ones", "zeros"."""
    d, nq, nkv, hd, V = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                         cfg["head_dim"], cfg["vocab"])
    out: List[Leaf] = [("embedding", (V, d), "w", "normal", 1 / math.sqrt(d))]
    if not cfg.get("tie_embeddings", False):
        out.append(("lm_head", (d, V), "w", "normal", 1 / math.sqrt(d)))
    out.append(("final_norm", (d,), "f32", "ones", 0.0))
    moe = "moe" in cfg.get("ffn_pattern", ["mlp"])
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "norm1", (d,), "f32", "ones", 0.0),
                (p + "norm2", (d,), "f32", "ones", 0.0),
                (p + "attn.w_q", (d, nq, hd), "w", "normal", 1 / math.sqrt(d)),
                (p + "attn.w_k", (d, nkv, hd), "w", "normal", 1 / math.sqrt(d)),
                (p + "attn.w_v", (d, nkv, hd), "w", "normal", 1 / math.sqrt(d)),
                (p + "attn.w_o", (nq, hd, d), "w", "normal",
                 1 / math.sqrt(nq * hd))]
        if cfg.get("qkv_bias", False):
            out += [(p + "attn.b_q", (nq, hd), "w", "zeros", 0.0),
                    (p + "attn.b_k", (nkv, hd), "w", "zeros", 0.0),
                    (p + "attn.b_v", (nkv, hd), "w", "zeros", 0.0)]
        if moe:
            E, f = cfg["n_experts"], cfg["d_expert"]
            fs = cfg["n_shared_experts"] * f
            out += [(p + "moe.router", (d, E), "f32", "normal", 1 / math.sqrt(d)),
                    (p + "moe.w_gate", (E, d, f), "w", "normal", 1 / math.sqrt(d)),
                    (p + "moe.w_up", (E, d, f), "w", "normal", 1 / math.sqrt(d)),
                    (p + "moe.w_down", (E, f, d), "w", "normal", 1 / math.sqrt(f))]
            if fs:
                out += [(p + "moe.shared.w_gate", (d, fs), "w", "normal",
                         1 / math.sqrt(d)),
                        (p + "moe.shared.w_up", (d, fs), "w", "normal",
                         1 / math.sqrt(d)),
                        (p + "moe.shared.w_down", (fs, d), "w", "normal",
                         1 / math.sqrt(fs))]
        else:
            ff = cfg["d_ff"]
            out += [(p + "mlp.w_gate", (d, ff), "w", "normal", 1 / math.sqrt(d)),
                    (p + "mlp.w_up", (d, ff), "w", "normal", 1 / math.sqrt(d)),
                    (p + "mlp.w_down", (ff, d), "w", "normal", 1 / math.sqrt(ff))]
    return out


# ----------------------------------------------------------------------
# precision of the weights as the forward reads them
# ----------------------------------------------------------------------
def exact(name: str, w: torch.Tensor) -> torch.Tensor:
    return w.float()


def _in_dims(name: str, w: torch.Tensor) -> Tuple[int, ...]:
    """The axes a weight contracts over (the scale is per remaining
    entry, i.e. per output channel)."""
    if name == "embedding":
        return (1,)
    if name.endswith("attn.w_o"):
        return (0, 1)
    if ".moe.w_" in name:
        return (1,)
    return (0,)


def control(name: str, w: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with a scale per output channel; vectors (norms,
    biases) and the float32 router stay as they are."""
    w = w.float()
    if w.dim() < 2 or name.endswith("router"):
        return w
    amax = w.abs().amax(dim=_in_dims(name, w), keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------
def _rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x, pos, theta):
    """x (S, H, hd), pos (S,): rotate the two halves."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64,
                                   device=x.device) / half)
    ang = (pos.double()[:, None] * freq[None]).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                      x1 * ang.sin() + x2 * ang.cos()], -1)


def _attention(q, k, v, chunk: int = 1024):
    """Causal attention, q (S, nq, hd), k / v (S, nkv, hd), float32."""
    S, nq, hd = q.shape
    rep = nq // k.shape[1]
    k = k.repeat_interleave(rep, 1).transpose(0, 1)            # (nq, S, hd)
    v = v.repeat_interleave(rep, 1).transpose(0, 1)
    q = q.transpose(0, 1) / math.sqrt(hd)
    out = torch.empty_like(q)
    kpos = torch.arange(S, device=q.device)
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        s = q[:, c0:c1] @ k[:, :c1].transpose(1, 2)              # (nq, C, c1)
        qpos = torch.arange(c0, c1, device=q.device)
        s = s.masked_fill(kpos[None, None, :c1] > qpos[None, :, None],
                          float("-inf"))
        out[:, c0:c1] = torch.softmax(s, -1) @ v[:, :c1]
    return out.transpose(0, 1)


def _swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def _moe(cfg, W, p, x, cast):
    E, k = cfg["n_experts"], cfg["moe_top_k"]
    probs = torch.softmax(x @ W[p + "moe.router"].float(), -1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    y = torch.zeros_like(x)
    wg, wu, wd = (cast(p + n, W[p + n]) for n in
                  ("moe.w_gate", "moe.w_up", "moe.w_down"))
    for e in range(E):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y.index_add_(0, tok, _swiglu(x[tok], wg[e], wu[e], wd[e])
                         * gate[tok, slot][:, None])
    del wg, wu, wd
    if p + "moe.shared.w_gate" in W:
        y = y + _swiglu(x, *(cast(p + n, W[p + n]) for n in
                             ("moe.shared.w_gate", "moe.shared.w_up",
                              "moe.shared.w_down")))
    return y


@torch.no_grad()
def hidden(cfg: dict, W: Dict[str, torch.Tensor], tokens: torch.Tensor,
           cast: Callable = exact) -> torch.Tensor:
    """Final-normed float32 hidden states (S, d) of ``tokens`` (S,)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = cfg["rms_eps"]
    S = tokens.shape[0]
    d, nq, nkv, hd = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                      cfg["head_dim"])
    pos = torch.arange(S, device=tokens.device)
    x = cast("embedding", W["embedding"])[tokens]
    moe = "moe" in cfg.get("ffn_pattern", ["mlp"])
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        h = _rmsnorm(x, W[p + "norm1"], eps)
        q = (h @ cast(p + "attn.w_q", W[p + "attn.w_q"]).reshape(d, -1)
             ).reshape(S, nq, hd)
        k = (h @ cast(p + "attn.w_k", W[p + "attn.w_k"]).reshape(d, -1)
             ).reshape(S, nkv, hd)
        v = (h @ cast(p + "attn.w_v", W[p + "attn.w_v"]).reshape(d, -1)
             ).reshape(S, nkv, hd)
        if p + "attn.b_q" in W:
            q = q + W[p + "attn.b_q"].float()
            k = k + W[p + "attn.b_k"].float()
            v = v + W[p + "attn.b_v"].float()
        if cfg.get("rope_type", "rope") == "rope":
            q = _rope(q, pos, cfg["rope_theta"])
            k = _rope(k, pos, cfg["rope_theta"])
        o = _attention(q, k, v).reshape(S, nq * hd)
        x = x + o @ cast(p + "attn.w_o", W[p + "attn.w_o"]).reshape(nq * hd, d)
        h = _rmsnorm(x, W[p + "norm2"], eps)
        if moe:
            x = x + _moe(cfg, W, p, h, cast)
        else:
            x = x + _swiglu(h, *(cast(p + n, W[p + n]) for n in
                                 ("mlp.w_gate", "mlp.w_up", "mlp.w_down")))
    return _rmsnorm(x, W["final_norm"], eps)


@torch.no_grad()
def logits(cfg: dict, W: Dict[str, torch.Tensor], h: torch.Tensor,
           cast: Callable = exact) -> torch.Tensor:
    """float32 logits (n, V) of hidden rows h (n, d)."""
    if "lm_head" in W:
        return h @ cast("lm_head", W["lm_head"])
    return h @ cast("embedding", W["embedding"]).T
