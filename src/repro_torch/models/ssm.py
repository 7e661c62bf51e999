"""State-space and recurrent sequence mixers: Mamba, mLSTM, sLSTM
(mirrors ``repro.models.ssm``).

Each mixer is an ``nn.Module`` holding the reference's parameter leaves
under the reference's names, and plain functions on tensors run it:

  mamba_seq / mamba_step     selective scan; the sequence form runs the
                             reference's chunked scan, chunks of
                             min(256, S), each an associative scan in
                             ``jax.lax.associative_scan``'s combine order;
  mlstm_parallel             the quadratic decay-masked form (training and
                             the teacher-forced oracle);
  mlstm_seq_recurrent /      the matrix-memory recurrence (prefill,
  mlstm_step                 extend, decode);
  slstm_seq / slstm_step     the scalar-memory recurrence with its
                             block-diagonal per-head recurrent weights.

The reference's ``lax.scan`` over positions is a Python loop here.  A
step's state is a set of NEW tensors, never written in place, so a
trajectory (``collect_traj``: the state after every position, for
speculative-decoding rollback) holds references to the states the loop
made anyway and is stacked once, per layer, to (B, S, ...).

Leaves the reference reads as float32 whatever the compute dtype
(Mamba's ``dt_proj``/``dt_bias``/``A_log``/``D``, mLSTM's gate weights
and biases, sLSTM's input bias and recurrent weights, every norm weight)
are stored as float32; the others in the model's dtype, cast to the
activations' dtype at each use as the reference's ``astype(dt)``.

``jax.nn.gelu`` defaults to the tanh approximation, and
``jax.nn.softplus`` is ``logaddexp(x, 0)`` with no threshold; the port
writes both out (``_gelu``, ``_softplus``) rather than take torch's
defaults.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import param, rmsnorm
from repro_torch.sharding.local import (as_dtensor, contiguous_grad,
                                       is_dtensor, laid_out_as)

MAMBA_CHUNK = 256
F32 = torch.float32


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    with no switch to x for large inputs."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -_softplus(-x)


def _gelu(x):
    """``jax.nn.gelu`` (approximate=True, its default)."""
    return F.gelu(x, approximate="tanh")


def _silu32(x):
    return F.silu(x.float())


def _mlstm_dims(cfg: ModelConfig):
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    return di, cfg.n_heads, di // cfg.n_heads


def _slstm_dff(cfg: ModelConfig) -> int:
    return max(128, int(round(cfg.slstm_proj_factor * cfg.d_model / 128))
               * 128)


# ======================================================================
# Mamba
# ======================================================================
class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, di, ds, dtr = cfg.d_model, cfg.d_inner, cfg.mamba_d_state, \
            cfg.dt_rank
        self.in_proj = param(d, 2 * di, dtype=dtype, device=device)
        self.conv_w = param(cfg.mamba_d_conv, di, dtype=dtype, device=device)
        self.conv_b = param(di, dtype=dtype, device=device, fill=0.0)
        self.x_proj = param(di, dtr + 2 * ds, dtype=dtype, device=device)
        self.dt_proj = param(dtr, di, dtype=F32, device=device)
        self.dt_bias = param(di, dtype=F32, device=device, fill=-4.6)
        A = torch.arange(1, ds + 1, dtype=F32, device=device)
        self.A_log = nn.Parameter(torch.log(A).expand(di, ds).clone(),
                                  requires_grad=False)
        self.D = param(di, dtype=F32, device=device, fill=1.0)
        self.out_proj = param(di, d, dtype=dtype, device=device)


def _causal_conv(x, w, b, state):
    """Depthwise causal conv along S.  x: (B, S, di), w: (K, di), state:
    (B, K-1, di) trailing context.  Returns (out, new state)."""
    K, S = w.shape[0], x.shape[1]
    xp = torch.cat([state, x], 1)                       # (B, S+K-1, di)
    out = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i].to(x.dtype)
    return out + b.to(x.dtype), xp[:, S:]


def _ssm_inputs(cfg: ModelConfig, p: Mamba, xc):
    """xc: post-conv activations (B, S, di) -> (A_bar, Bx) (B, S, di, ds)
    and C (B, S, ds), float32."""
    ds, dtr = cfg.mamba_d_state, cfg.dt_rank
    proj = (xc @ p.x_proj.to(xc.dtype)).float()
    dt_raw, B_ssm, C_ssm = proj.split([dtr, ds, ds], -1)
    dt = _softplus(dt_raw @ p.dt_proj + p.dt_bias)      # (B, S, di)
    A = -torch.exp(p.A_log)                             # (di, ds)
    A_bar = torch.exp(dt[..., None] * A)
    Bx = (dt * xc.float())[..., None] * B_ssm[..., None, :]
    return A_bar, Bx, C_ssm


def _combine(a, b):
    """The scan's operator on (A, h) pairs: (Aa Ab, Ab ha + hb)."""
    (Aa, ha), (Ab, hb) = a, b
    return Aa * Ab, Ab * ha + hb


def _interleave(a, b):
    """a0 b0 a1 b1 ... along axis 1 (len(a) = len(b) or len(b) + 1)."""
    out = torch.empty((a.shape[0], a.shape[1] + b.shape[1]) + a.shape[2:],
                      dtype=a.dtype, device=a.device)
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _associative_scan(A, h):
    """Inclusive scan of ``_combine`` over axis 1, in the combine order of
    ``jax.lax.associative_scan``: adjacent pairs reduced, the half-length
    scan recursed, the even positions combined from it."""
    n = A.shape[1]
    if n < 2:
        return A, h
    oA, oh = _associative_scan(*_combine((A[:, 0:-1:2], h[:, 0:-1:2]),
                                         (A[:, 1::2], h[:, 1::2])))
    if n % 2 == 0:
        eA, eh = _combine((oA[:, :-1], oh[:, :-1]), (A[:, 2::2], h[:, 2::2]))
    else:
        eA, eh = _combine((oA, oh), (A[:, 2::2], h[:, 2::2]))
    eA = torch.cat([A[:, :1], eA], 1)
    eh = torch.cat([h[:, :1], eh], 1)
    return _interleave(eA, oA), _interleave(eh, oh)


def _scan_chunked(A_bar, Bx, h0):
    """h_t = A_t h_{t-1} + b_t over axis 1, in chunks of min(256, S)
    halved until they divide S.  Returns (h_all (B, S, di, ds), h_T)."""
    S = A_bar.shape[1]
    C = min(MAMBA_CHUNK, S)
    while S % C:
        C //= 2
    hs, h = [], h0
    for c in range(0, S, C):
        Acum, hloc = _associative_scan(A_bar[:, c:c + C], Bx[:, c:c + C])
        hc = hloc + Acum * h[:, None]
        hs.append(hc)
        h = hc[:, -1]
    return (hs[0] if len(hs) == 1 else torch.cat(hs, 1)), h


def mamba_seq(cfg: ModelConfig, p: Mamba, x, state=None,
              return_state: bool = False, collect_traj: bool = False):
    """Full-sequence Mamba.  x: (B, S, d); state: {"conv" (B, K-1, di),
    "ssm" (B, di, ds)} or None (zeros).  Returns out, or (out, state), or
    with ``collect_traj`` (out, state, trajectory): the conv window and
    the ssm state after every position, (B, S, K-1, di) and
    (B, S, di, ds)."""
    dt = x.dtype
    B, S, _ = x.shape
    di, ds, K = cfg.d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    x1, z = (x @ p.in_proj.to(dt)).chunk(2, -1)
    if state is None:
        conv_state = torch.zeros((B, K - 1, di), dtype=x1.dtype,
                                 device=x.device)
        h0 = torch.zeros((B, di, ds), dtype=F32, device=x.device)
    else:
        conv_state, h0 = state["conv"].to(x1.dtype), state["ssm"].float()
    xc, new_conv = _causal_conv(x1, p.conv_w, p.conv_b, conv_state)
    xc = _silu32(xc).to(dt)
    A_bar, Bx, C_ssm = _ssm_inputs(cfg, p, xc)
    hs, hT = _scan_chunked(A_bar, Bx, h0)
    y = (hs * C_ssm[:, :, None, :]).sum(-1)             # (B, S, di)
    y = y + p.D * xc.float()
    y = (y * _silu32(z)).to(dt)
    out = y @ p.out_proj.to(dt)
    if not return_state:
        return out
    new = {"conv": new_conv, "ssm": hT}
    if not collect_traj:
        return out, new
    # the conv window AFTER step t: rows t+1 .. t+K-1 of [conv_state; x1]
    xp = torch.cat([conv_state, x1], 1)
    idx = (torch.arange(S, device=x.device)[:, None] + 1
           + torch.arange(K - 1, device=x.device)[None, :])
    return out, new, {"conv": xp[:, idx], "ssm": hs}


def mamba_step(cfg: ModelConfig, p: Mamba, x, state):
    """One decode step.  x: (B, 1, d).  Returns (out (B, 1, d), state)."""
    dt = x.dtype
    x1, z = (x @ p.in_proj.to(dt)).chunk(2, -1)
    xc, new_conv = _causal_conv(x1, p.conv_w, p.conv_b, state["conv"])
    xc = _silu32(xc).to(dt)
    A_bar, Bx, C_ssm = _ssm_inputs(cfg, p, xc)
    h = A_bar[:, 0] * state["ssm"] + Bx[:, 0]           # (B, di, ds)
    y = (h * C_ssm[:, 0, None, :]).sum(-1)
    y = y + p.D * xc[:, 0].float()
    y = (y * _silu32(z[:, 0])).to(dt)
    return (y @ p.out_proj.to(dt))[:, None], {"conv": new_conv, "ssm": h}


def make_mamba_state(cfg: ModelConfig, batch: int, dtype, device):
    return {"conv": torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, cfg.d_inner, cfg.mamba_d_state),
                               dtype=F32, device=device)}


# ======================================================================
# mLSTM (xLSTM matrix-memory block)
# ======================================================================
class MLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        di, nh, dh = _mlstm_dims(cfg)
        self.up_proj = param(d, 2 * di, dtype=dtype, device=device)
        self.w_q = param(nh, dh, dh, dtype=dtype, device=device)
        self.w_k = param(nh, dh, dh, dtype=dtype, device=device)
        self.w_v = param(nh, dh, dh, dtype=dtype, device=device)
        self.w_i = param(di, nh, dtype=F32, device=device)
        self.w_f = param(di, nh, dtype=F32, device=device)
        self.b_i = param(nh, dtype=F32, device=device, fill=0.0)
        self.b_f = param(nh, dtype=F32, device=device, fill=3.0)
        self.norm_w = param(di, dtype=F32, device=device, fill=1.0)
        self.down_proj = param(di, d, dtype=dtype, device=device)


def _mlstm_qkvif(cfg: ModelConfig, p: MLSTM, xm):
    """xm: (B, S, di) -> q, k, v (B, S, nh, dh) in xm's dtype and the
    float32 log-gates (B, S, nh)."""
    dt = xm.dtype
    B, S, di = xm.shape
    _, nh, dh = _mlstm_dims(cfg)
    xh = xm.reshape(B, S, nh, dh)
    q = torch.einsum("bsnh,nhg->bsng", xh, p.w_q.to(dt))
    k = torch.einsum("bsnh,nhg->bsng", xh, p.w_k.to(dt))
    k = k / torch.sqrt(torch.tensor(float(dh), dtype=dt, device=xm.device))
    v = torch.einsum("bsnh,nhg->bsng", xh, p.w_v.to(dt))
    logi = xm.float() @ p.w_i + p.b_i
    logf = _log_sigmoid(xm.float() @ p.w_f + p.b_f)
    return q, k, v, logi, logf


def _mlstm_out(cfg: ModelConfig, p: MLSTM, h, z):
    """h: (B, S, di) cell outputs -> the block's output (B, S, d)."""
    h = rmsnorm(h, p.norm_w, cfg.rms_eps)
    h = h * _silu32(z).to(h.dtype)
    return h @ p.down_proj.to(h.dtype)


def mlstm_parallel(cfg: ModelConfig, p: MLSTM, x):
    """The quadratic parallel form (training, the teacher-forced
    oracle)."""
    dt = x.dtype
    B, S, _ = x.shape
    di, _, _ = _mlstm_dims(cfg)
    xm, z = (x @ p.up_proj.to(dt)).chunk(2, -1)
    q, k, v, logi, logf = _mlstm_qkvif(cfg, p, xm)
    Fc = torch.cumsum(logf, 1)                          # (B, S, nh)
    # D[b, n, i, j] = F_i - F_j + logi_j  (j <= i)
    Dm = (Fc[:, :, None, :] - Fc[:, None, :, :]
          + logi[:, None, :, :]).movedim(-1, 1)         # (B, nh, S, S)
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    Dm = torch.where(causal, Dm, float("-inf"))
    m = Dm.amax(-1, keepdim=True)
    Dexp = torch.exp(Dm - m)
    logits = torch.einsum("bing,bjng->bnij", q.float(), k.float())
    Smat = logits * Dexp
    n = torch.maximum(Smat.sum(-1, keepdim=True).abs(), torch.exp(-m))
    h = torch.einsum("bnij,bjng->bing", Smat / n, v.float())
    return _mlstm_out(cfg, p, h.reshape(B, S, di).to(dt), z)


def _mlstm_step_core(q, k, v, logi, logf, state):
    """One recurrent step.  q, k, v: (B, nh, dh) float32; gates (B, nh);
    state {"C" (B, nh, dh, dh), "n" (B, nh, dh), "m" (B, nh)}.  Returns
    (h (B, nh, dh), new state)."""
    m_prev, C_prev, n_prev = state["m"], state["C"], state["n"]
    m_new = torch.maximum(logf + m_prev, logi)
    i_p = torch.exp(logi - m_new)[..., None]            # (B, nh, 1)
    f_p = torch.exp(logf + m_prev - m_new)[..., None]
    C = f_p[..., None] * C_prev + i_p[..., None] * \
        (v[..., :, None] * k[..., None, :])             # (B, nh, dh, dh)
    n = f_p * n_prev + i_p * k
    num = (C @ q[..., None])[..., 0]                    # C q over the k axis
    den = torch.maximum((n * q).sum(-1).abs(), torch.exp(-m_new))[..., None]
    return num / den, {"C": C, "n": n, "m": m_new}


def _stack_states(states):
    """A list over positions of state dicts -> one dict of (B, S, ...)."""
    return {name: torch.stack([s[name] for s in states], 1)
            for name in states[0]}


def mlstm_seq_recurrent(cfg: ModelConfig, p: MLSTM, x, state=None,
                        return_state: bool = False,
                        collect_traj: bool = False):
    """The recurrent form over a sequence (prefill / extend)."""
    dt = x.dtype
    B, S, _ = x.shape
    di, _, _ = _mlstm_dims(cfg)
    xm, z = (x @ p.up_proj.to(dt)).chunk(2, -1)
    q, k, v, logi, logf = _mlstm_qkvif(cfg, p, xm)
    st = state if state is not None else \
        make_mlstm_state(cfg, B, x.device)
    qf, kf, vf = q.float(), k.float(), v.float()
    hs, traj = [], []
    for t in range(S):
        h, st = _mlstm_step_core(qf[:, t], kf[:, t], vf[:, t], logi[:, t],
                                 logf[:, t], st)
        hs.append(h)
        if collect_traj:
            traj.append(st)
    h = torch.stack(hs, 1).reshape(B, S, di).to(dt)
    out = _mlstm_out(cfg, p, h, z)
    if not return_state:
        return out
    if not collect_traj:
        return out, st
    return out, st, _stack_states(traj)


def mlstm_step(cfg: ModelConfig, p: MLSTM, x, state):
    """One decode step.  x: (B, 1, d)."""
    dt = x.dtype
    B = x.shape[0]
    di, _, _ = _mlstm_dims(cfg)
    xm, z = (x @ p.up_proj.to(dt)).chunk(2, -1)
    q, k, v, logi, logf = _mlstm_qkvif(cfg, p, xm)
    h, st = _mlstm_step_core(q[:, 0].float(), k[:, 0].float(),
                             v[:, 0].float(), logi[:, 0], logf[:, 0], state)
    return _mlstm_out(cfg, p, h.reshape(B, 1, di).to(dt), z), st


def make_mlstm_state(cfg: ModelConfig, batch: int, device):
    _, nh, dh = _mlstm_dims(cfg)
    return {"C": torch.zeros((batch, nh, dh, dh), dtype=F32, device=device),
            "n": torch.zeros((batch, nh, dh), dtype=F32, device=device),
            "m": torch.full((batch, nh), -1e30, dtype=F32, device=device)}


# ======================================================================
# sLSTM (xLSTM scalar-memory block)
# ======================================================================
class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        dh, dff = d // nh, _slstm_dff(cfg)
        self.w_in = param(d, 4 * d, dtype=dtype, device=device)  # i,f,z,o
        b_in = torch.zeros(4 * d, dtype=F32, device=device)
        b_in[d:2 * d] = 3.0
        self.b_in = nn.Parameter(b_in, requires_grad=False)
        self.r = param(4, nh, dh, dh, dtype=F32, device=device)
        self.norm_w = param(d, dtype=F32, device=device, fill=1.0)
        self.ffn_up = param(d, dff, dtype=dtype, device=device)
        self.ffn_down = param(dff, d, dtype=dtype, device=device)


def _slstm_step_core(cfg: ModelConfig, p: SLSTM, xt, st):
    """xt: (B, 4d) input projection, float32; st {"h", "c", "n", "m"}
    (B, d).  Returns (h, new state)."""
    d, nh = cfg.d_model, cfg.n_heads
    B = xt.shape[0]
    hprev = st["h"].reshape(B, nh, d // nh)
    rec = torch.einsum("bnh,knhg->bkng", hprev, p.r).reshape(B, 4 * d)
    it, ft, zt, ot = (xt + rec + p.b_in).chunk(4, -1)
    logf = _log_sigmoid(ft)
    m_new = torch.maximum(logf + st["m"], it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(logf + st["m"] - m_new)
    c = f_p * st["c"] + i_p * torch.tanh(zt)
    n = f_p * st["n"] + i_p
    h = torch.sigmoid(ot) * c / torch.clamp_min(n, 1e-6)
    return h, {"h": h, "c": c, "n": n, "m": m_new}


def _slstm_out(cfg: ModelConfig, p: SLSTM, h):
    h = rmsnorm(h, p.norm_w, cfg.rms_eps)
    ff = _gelu((h @ p.ffn_up.to(h.dtype)).float())
    return ff.to(h.dtype) @ p.ffn_down.to(h.dtype)


def slstm_seq(cfg: ModelConfig, p: SLSTM, x, state=None,
              return_state: bool = False, collect_traj: bool = False):
    dt = x.dtype
    B, S, _ = x.shape
    st = state if state is not None else make_slstm_state(cfg, B, x.device)
    xin = (x @ p.w_in.to(dt)).float()                   # (B, S, 4d)
    hs, traj = [], []
    for t in range(S):
        h, st = _slstm_step_core(cfg, p, xin[:, t], st)
        hs.append(h)
        if collect_traj:
            traj.append(st)
    out = _slstm_out(cfg, p, torch.stack(hs, 1).to(dt))
    if not return_state:
        return out
    if not collect_traj:
        return out, st
    return out, st, _stack_states(traj)


def slstm_step(cfg: ModelConfig, p: SLSTM, x, state):
    dt = x.dtype
    xin = (x[:, 0] @ p.w_in.to(dt)).float()
    h, st = _slstm_step_core(cfg, p, xin, state)
    return _slstm_out(cfg, p, h[:, None].to(dt)), st


def make_slstm_state(cfg: ModelConfig, batch: int, device):
    z = torch.zeros((batch, cfg.d_model), dtype=F32, device=device)
    return {"h": z, "c": z, "n": z,
            "m": torch.full((batch, cfg.d_model), -1e30, dtype=F32,
                            device=device)}


MIXERS = {"mamba": Mamba, "mlstm": MLSTM, "slstm": SLSTM}


def make_state(cfg: ModelConfig, block_type: str, batch: int, dtype,
               device):
    """A stateful layer's zero state (the reference's make_*_state)."""
    if block_type == "mamba":
        return make_mamba_state(cfg, batch, dtype, device)
    if block_type == "mlstm":
        return make_mlstm_state(cfg, batch, device)
    return make_slstm_state(cfg, batch, device)


def seq(cfg: ModelConfig, block_type: str, p, x, state=None,
        collect_traj: bool = False):
    """The serve-mode sequence form of a stateful mixer: (out, state,
    trajectory), the trajectory None without ``collect_traj``."""
    if _on_dtensors(p, x):
        if collect_traj:
            raise NotImplementedError("state trajectories on DTensors")
        return (*_sharded(cfg, block_type, p, x, state), None)
    fn = {"mamba": mamba_seq, "mlstm": mlstm_seq_recurrent,
          "slstm": slstm_seq}[block_type]
    out = fn(cfg, p, x, state=state, return_state=True,
             collect_traj=collect_traj)
    return out if collect_traj else (*out, None)


def train_seq(cfg: ModelConfig, block_type: str, p, x):
    """The train-mode form: Mamba's scan without state, mLSTM's parallel
    form, sLSTM's recurrence."""
    if _on_dtensors(p, x):
        return _sharded(cfg, block_type, p, x, None, train=True)
    if block_type == "mamba":
        return mamba_seq(cfg, p, x)
    if block_type == "mlstm":
        return mlstm_parallel(cfg, p, x)
    return slstm_seq(cfg, p, x)


def _on_dtensors(p, x) -> bool:
    return is_dtensor(x) or (isinstance(p, nn.Module) and
                             is_dtensor(next(p.parameters())))


def _sharded(cfg: ModelConfig, block_type: str, p, x, state, train=False):
    """A stateful mixer on DTensors, per rank through ``local_map``: the
    rows sharded over the data axes where they divide, the layer's
    weights gathered over ``model`` (the all-gather DTensor issues, as
    FSDP gathers a layer: the mixers' recurrences are not split over
    channels here) and the state likewise, the new state handed back in
    the cache's own placements (a local slice).  Returns out (train) or
    (out, state)."""
    import types

    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    names = [n for n, _ in p.named_parameters(recurse=False)]
    prms = [getattr(p, n) for n in names]
    mesh = next(t for t in (x, *prms) if is_dtensor(t)).device_mesh
    dp_size = mesh.size() // mesh.size(list(mesh.mesh_dim_names).index(
        "model"))
    rows = Shard(0) if x.shape[0] % dp_size == 0 else Replicate()
    # activations and states: the rows over the data axes, whole over
    # ``model``
    row_pl = [Replicate() if n == "model" else rows
              for n in mesh.mesh_dim_names]
    keys = sorted(state) if state is not None else []
    sts = [as_dtensor(state[k], mesh) for k in keys]
    args = [as_dtensor(x, mesh), *(as_dtensor(t, mesh) for t in prms), *sts]
    in_pl = [row_pl] + [[Replicate()] * mesh.ndim] * len(prms) + \
        [row_pl] * len(sts)
    n_p = len(prms)

    def local(xl, *rest):
        xl = contiguous_grad(xl)
        pn = types.SimpleNamespace(**dict(zip(names, rest[:n_p])))
        st = dict(zip(keys, rest[n_p:])) or None
        if train:
            return train_seq(cfg, block_type, pn, xl)
        out, new, _ = seq(cfg, block_type, pn, xl, st)
        return (out, *(new[k] for k in sorted(new)))

    if train:
        # each rank's weight gradient is over its rows: partial over the
        # data axes that split them
        w_grad = [Partial() if n != "model" and rows.is_shard() else
                  Replicate() for n in mesh.mesh_dim_names]
        return local_map(local, out_placements=row_pl, in_placements=tuple(
            in_pl), in_grad_placements=(row_pl, *([w_grad] * n_p)),
            device_mesh=mesh, redistribute_inputs=True)(*args)
    new_keys = keys or sorted(make_state(cfg, block_type, 1, x.dtype,
                                         "meta"))
    outs = local_map(local, out_placements=(row_pl,) * (1 + len(new_keys)),
                     in_placements=tuple(in_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)
    new = dict(zip(new_keys, outs[1:]))
    if state is not None:
        new = {k: laid_out_as(v, state[k]) if is_dtensor(state[k]) else v
               for k, v in new.items()}
    return outs[0], new
