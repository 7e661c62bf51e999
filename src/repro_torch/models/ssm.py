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
                                       is_dtensor, laid_out_as, part_blocks,
                                       settled)

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


def _ssm_inputs(cfg: ModelConfig, p: Mamba, xc, proj=None):
    """xc: post-conv activations (B, S, di) -> (A_bar, Bx) (B, S, di, ds)
    and C (B, S, ds), float32.  ``proj``: xc @ x_proj in float32, when
    the caller has it (summed over the ranks that split di)."""
    ds, dtr = cfg.mamba_d_state, cfg.dt_rank
    if proj is None:
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
    out = _mamba_out(p, hs, C_ssm, xc, z)
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


def _mamba_out(p: Mamba, hs, C_ssm, xc, z):
    """The scan's states (B, S, di, ds) read out through C, the skip D
    and the z gate, then out_proj (xc's dtype)."""
    y = (hs * C_ssm[:, :, None, :]).sum(-1)             # (B, S, di)
    y = y + p.D * xc.float()
    y = (y * _silu32(z)).to(xc.dtype)
    return y @ p.out_proj.to(xc.dtype)


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


def _mlstm_qkv(cfg: ModelConfig, p: MLSTM, xm):
    """xm: (B, S, di) -> q, k, v (B, S, nh, ·) in xm's dtype (the heads'
    output width of p's w_q / w_k / w_v: dh, or one rank's block of
    it)."""
    dt = xm.dtype
    B, S, di = xm.shape
    _, nh, dh = _mlstm_dims(cfg)
    xh = xm.reshape(B, S, nh, dh)
    q = torch.einsum("bsnh,nhg->bsng", xh, p.w_q.to(dt))
    k = torch.einsum("bsnh,nhg->bsng", xh, p.w_k.to(dt))
    k = k / torch.sqrt(torch.tensor(float(dh), dtype=dt, device=xm.device))
    v = torch.einsum("bsnh,nhg->bsng", xh, p.w_v.to(dt))
    return q, k, v


def _mlstm_gates(p: MLSTM, gi, gf):
    """The float32 log-gates (B, S, nh) from xm @ w_i and xm @ w_f."""
    return gi + p.b_i, _log_sigmoid(gf + p.b_f)


def _mlstm_qkvif(cfg: ModelConfig, p: MLSTM, xm):
    """xm: (B, S, di) -> q, k, v (B, S, nh, dh) in xm's dtype and the
    float32 log-gates (B, S, nh)."""
    return (*_mlstm_qkv(cfg, p, xm),
            *_mlstm_gates(p, xm.float() @ p.w_i, xm.float() @ p.w_f))


def _mlstm_out(cfg: ModelConfig, p: MLSTM, h, z, lo: int = 0):
    """h: (B, S, di) cell outputs -> the block's output (B, S, d).  With
    z, p.norm_w and p.down_proj one rank's block of the channels, from
    ``lo`` on, the rank's partial sum of it (the norm reads all of h)."""
    dt = h.dtype
    hf = h.float()
    hf = hf * torch.rsqrt((hf * hf).mean(-1, keepdim=True) + cfg.rms_eps)
    h = (hf[..., lo:lo + z.shape[-1]] * p.norm_w.float()).to(dt)
    h = h * _silu32(z).to(dt)
    return h @ p.down_proj.to(dt)


def mlstm_parallel(cfg: ModelConfig, p: MLSTM, x):
    """The quadratic parallel form (training, the teacher-forced
    oracle)."""
    dt = x.dtype
    B, S, _ = x.shape
    di, _, _ = _mlstm_dims(cfg)
    xm, z = (x @ p.up_proj.to(dt)).chunk(2, -1)
    h = _mlstm_parallel_h(*_mlstm_qkvif(cfg, p, xm))
    return _mlstm_out(cfg, p, h.reshape(B, S, di).to(dt), z)


def _mlstm_parallel_h(q, k, v, logi, logf):
    """The parallel form's cell outputs (B, S, nh, ·) float32, v's width
    (q and k whole over dh)."""
    B, S = q.shape[:2]
    Fc = torch.cumsum(logf, 1)                          # (B, S, nh)
    # D[b, n, i, j] = F_i - F_j + logi_j  (j <= i)
    Dm = (Fc[:, :, None, :] - Fc[:, None, :, :]
          + logi[:, None, :, :]).movedim(-1, 1)         # (B, nh, S, S)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    Dm = torch.where(causal, Dm, float("-inf"))
    m = Dm.amax(-1, keepdim=True)
    Dexp = torch.exp(Dm - m)
    logits = torch.einsum("bing,bjng->bnij", q.float(), k.float())
    Smat = logits * Dexp
    n = torch.maximum(Smat.sum(-1, keepdim=True).abs(), torch.exp(-m))
    return torch.einsum("bnij,bjng->bing", Smat / n, v.float())


def _mlstm_step_core(q, k, v, logi, logf, state):
    """One recurrent step.  q, k, v: (B, nh, dh) float32; gates (B, nh);
    state {"C" (B, nh, dh, dh), "n" (B, nh, dh), "m" (B, nh)}.  Returns
    (h (B, nh, dh), new state)."""
    num, nq, st = _mlstm_step_parts(q, k, v, logi, logf, state)
    den = torch.maximum(nq.abs(), torch.exp(-st["m"]))[..., None]
    return num / den, st


def _mlstm_step_parts(q, k, v, logi, logf, state):
    """One recurrent step up to its contractions over the key dim: (C q
    (B, nh, dh_v), n . q (B, nh), new state).  q, k, n and C's last dim
    may be one rank's block of dh (the sums then partial), v whole."""
    m_prev, C_prev, n_prev = state["m"], state["C"], state["n"]
    m_new = torch.maximum(logf + m_prev, logi)
    i_p = torch.exp(logi - m_new)[..., None]            # (B, nh, 1)
    f_p = torch.exp(logf + m_prev - m_new)[..., None]
    C = f_p[..., None] * C_prev + i_p[..., None] * \
        (v[..., :, None] * k[..., None, :])             # (B, nh, dh, dh)
    n = f_p * n_prev + i_p * k
    num = (C @ q[..., None])[..., 0]                    # C q over the k axis
    return num, (n * q).sum(-1), {"C": C, "n": n, "m": m_new}


# Set by the dry run's calibrated count (``launch.dryrun``): a
# ``comm_analysis.DeviceCostMode``, whose ``counts`` / ``since`` / ``add``
# / ``stand_in`` / ``repeat_backward`` let a position loop dispatch a few
# trips and stand for the rest; None runs every trip.
POSITION_LOOP = None


def _loop(n: int, trip, st):
    """A recurrence over n positions: trip(t, st) -> (outputs, st), the
    outputs a tuple (or pytree) of (B, ...) tensors.  Returns (each
    output over the positions, (B, n, ...), in the outputs' structure;
    the final state).  Without gradients each trip's outputs are written
    into buffers as they come; with gradients they are stacked once
    (autograd would clone a written buffer a trip).

    With ``POSITION_LOOP`` set the loop dispatches trips 0 and 1 (0 to 3
    with gradients), adds trip 1's counts (and a middle trip's backward,
    the counts between the gradients of the states that trips 2 and 1
    hand on, through hooks) for the trips not dispatched, and gives their
    outputs and the final state as uncounted stand-ins of the same
    shapes; with gradients, what trip 2 kept alive for the backward,
    once for each trip not dispatched, is one stand-in until the
    backward has passed trip 2."""
    from torch.utils._pytree import tree_flatten, tree_unflatten
    grad = torch.is_grad_enabled()
    cost = POSITION_LOOP if n > 4 else None
    run = n if cost is None else 4 if grad else 2
    outs, bufs = [], None
    for t in range(run):
        if t == 1 and cost is not None:
            mark = cost.counts()
        o, st = trip(t, st)
        leaves, spec = tree_flatten(o)
        if grad:
            outs.append(leaves)
        else:
            if bufs is None:
                bufs = [x.new_empty((x.shape[0], n) + tuple(x.shape[1:]))
                        for x in leaves]
            for b, x in zip(bufs, leaves):
                b[:, t] = x
        if t == 1 and cost is not None:
            one, live = cost.since(mark), cost.live
            if grad:
                bw = cost.repeat_backward(n - run)
                bw.ends_at(st)
        if t == 2 and grad and cost is not None:
            bw.starts_at(st)
            # what a trip keeps alive for the backward besides its outputs
            bw.keep((n - run) * (cost.live - live
                                 - cost.storage_of(leaves)))
    if cost is not None:
        cost.add(one, n - run)
        if grad:
            outs += cost.stand_in_trips(outs[-1], n - run)
        st = cost.stand_in(st)
    if grad:
        bufs = [torch.stack(xs, 1) for xs in zip(*outs)]
    return tree_unflatten(bufs, spec), st


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

    def trip(t, st):
        h, st = _mlstm_step_core(qf[:, t], kf[:, t], vf[:, t], logi[:, t],
                                 logf[:, t], st)
        return ((h, st) if collect_traj else (h,)), st

    outs, st = _loop(S, trip, st)
    out = _mlstm_out(cfg, p, outs[0].reshape(B, S, di).to(dt), z)
    if not return_state:
        return out
    if not collect_traj:
        return out, st
    return out, st, outs[1]


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
    return _slstm_cell(xt + rec + p.b_in, st)


def _slstm_cell(pre, st):
    """The cell update from its gates' pre-activations (B, 4 n), [i, f,
    z, o] over the n channels of st's (B, n) leaves."""
    it, ft, zt, ot = pre.chunk(4, -1)
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
    hs, st, traj = _slstm_loop(cfg, p, xin, st, collect_traj)
    out = _slstm_out(cfg, p, hs.to(dt))
    if not return_state:
        return out
    if not collect_traj:
        return out, st
    return out, st, traj


def _slstm_loop(cfg: ModelConfig, p: SLSTM, xin, st, collect_traj=False):
    """The recurrence over xin (B, S, 4d) float32 from state st: (h (B,
    S, d), the final state, the state after every position with
    ``collect_traj``, else None)."""
    def trip(t, st):
        h, st = _slstm_step_core(cfg, p, xin[:, t], st)
        return ((h, st) if collect_traj else (h,)), st

    outs, st = _loop(xin.shape[1], trip, st)
    return outs[0], st, outs[1] if collect_traj else None


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


# ======================================================================
# On DTensors (the dry run): each mixer on its ``model`` shard
# ======================================================================
# the leaves ``sharding.partition`` shards over ``model``; a mixer's other
# leaves (biases over heads or gates, sLSTM's norm) stay whole
MODEL_LEAVES = {
    "mamba": ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
              "A_log", "D", "out_proj"),
    "mlstm": ("up_proj", "w_q", "w_k", "w_v", "w_i", "w_f", "norm_w",
              "down_proj"),
    "slstm": ("w_in", "r", "ffn_up", "ffn_down"),
}


class _Shards:
    """One sharded mixer call's mesh, ``model`` dim and placements: an
    activation's rows over the data axes where they divide, anything on
    ``model``; a weight's own placements, its gradient partial over the
    data axes that split the rows."""

    def __init__(self, p, x, state):
        from torch.distributed.tensor import Replicate, Shard
        self.names = [n for n, _ in p.named_parameters(recurse=False)]
        self.w = {n: getattr(p, n) for n in self.names}
        self.mesh = mesh = next(t for t in (x, *self.w.values())
                                if is_dtensor(t)).device_mesh
        self.mi = list(mesh.mesh_dim_names).index("model")
        self.M = mesh.size(self.mi)
        self.rank = mesh.get_local_rank(self.mi)
        self.rows = Shard(0) if x.shape[0] % (mesh.size() // self.M) == 0 \
            else Replicate()
        self.x = as_dtensor(x, mesh)
        self.state = None if state is None else \
            {k: as_dtensor(v, mesh) for k, v in state.items()}

    def pl(self, model=None):
        from torch.distributed.tensor import Replicate
        return [(model or Replicate()) if i == self.mi else self.rows
                for i in range(self.mesh.ndim)]

    def wpl(self, name):
        w = self.w[name]
        if any(not p.is_replicate() for i, p in enumerate(w.placements)
               if i != self.mi):
            raise NotImplementedError(f"{name} is sharded over a data axis")
        return list(w.placements)

    def wgrad(self, name):
        from torch.distributed.tensor import Partial
        return [p if i == self.mi else
                (Partial() if self.rows.is_shard() else p)
                for i, p in enumerate(self.wpl(name))]

    def sharded(self, block_type) -> bool:
        """Whether the mixer's channels are split over ``model`` (every
        leaf of MODEL_LEAVES sharded) or whole on every rank (none is);
        anything between raises."""
        on = [self.w[n].placements[self.mi].is_shard()
              for n in MODEL_LEAVES[block_type]]
        if any(on) and not all(on):
            raise NotImplementedError(
                f"{block_type}: {dict(zip(MODEL_LEAVES[block_type], on))} "
                "sharded over model; its sharded form needs all of them")
        return all(on)

    def whole(self, t):
        """The DTensor ``t`` whole over ``model`` (gathered or summed)."""
        from torch.distributed.tensor import Replicate
        t = settled(t)
        return t.redistribute(self.mesh, [
            Replicate() if i == self.mi else p
            for i, p in enumerate(t.placements)])

    def pgrad(self, name):
        """The gradient placements of a weight whole over ``model`` that
        every rank uses for its own channels: partial over ``model`` (and
        the data axes that split the rows)."""
        from torch.distributed.tensor import Partial
        return [Partial() if i == self.mi else g
                for i, g in enumerate(self.wgrad(name))]

    def run(self, fn, args, in_pl, out_pl, grad_pl=None):
        from torch.distributed.tensor.experimental import local_map
        return local_map(fn, out_placements=tuple(out_pl),
                         in_placements=tuple(in_pl),
                         in_grad_placements=None if grad_pl is None
                         else tuple(grad_pl), device_mesh=self.mesh,
                         redistribute_inputs=True)(*args)

    def parts(self, u, n_parts):
        return part_blocks(u, n_parts, self.mesh, self.mi)


def _sharded(cfg: ModelConfig, block_type: str, p, x, state, train=False):
    """A stateful mixer on DTensors, per rank through ``local_map``.  The
    rows are sharded over the data axes where they divide.  With its
    leaves sharded over ``model`` (the rules' placements) each rank runs
    its own channels and only the collectives the math needs (``_mamba``
    / ``_mlstm`` / ``_slstm``); with its leaves whole (a ``model`` axis
    of one rank, or channels it does not divide) every rank runs the
    whole mixer.  Returns out (train) or (out, state), the new state in
    the cache's placements."""
    sh = _Shards(p, x, state)
    if sh.sharded(block_type):
        fn = {"mamba": _mamba, "mlstm": _mlstm, "slstm": _slstm}[block_type]
        res = fn(cfg, sh, train)
    else:
        res = _whole(cfg, block_type, sh, train)
    if train:
        return res
    out, new = res
    if state is not None:
        new = {k: laid_out_as(v, state[k]) if is_dtensor(state[k]) else v
               for k, v in new.items()}
    return out, new


def _whole(cfg, block_type, sh, train):
    """Every rank runs the whole mixer on its rows (so its input's
    gradient is whole too)."""
    keys = sorted(sh.state) if sh.state is not None else []
    n_p = len(sh.names)

    def local(xl, *rest):
        xl = contiguous_grad(xl)
        pn = _ns(**dict(zip(sh.names, rest[:n_p])))
        st = dict(zip(keys, rest[n_p:])) or None
        if train:
            return train_seq(cfg, block_type, pn, xl)
        out, new, _ = seq(cfg, block_type, pn, xl, st)
        return (out, *(new[k] for k in sorted(new)))

    args = [sh.x, *sh.w.values(), *(sh.state[k] for k in keys)]
    in_pl = [sh.pl()] + [sh.wpl(n) for n in sh.names] + \
        [sh.pl()] * len(keys)
    if train:
        grad = [sh.pl()] + [sh.wgrad(n) for n in sh.names]
        return sh.run(local, args, in_pl, [sh.pl()], grad)
    new_keys = keys or sorted(make_state(cfg, block_type, 1, sh.x.dtype,
                                         "meta"))
    outs = sh.run(local, args, in_pl, [sh.pl()] * (1 + len(new_keys)))
    return outs[0], dict(zip(new_keys, outs[1:]))


def _ns(**kw):
    """The leaves a mixer function reads, by name."""
    import types
    return types.SimpleNamespace(**kw)


def _mamba(cfg, sh, train):
    """Mamba over its rank's block of d_inner: in_proj's [x | z] columns
    regrouped to the block by one all-to-all, the conv and the scan
    local, x_proj's contraction over d_inner summed by one all-reduce of
    (B, S, dt_rank + 2 d_state) before the scan, out_proj's partial sum
    left to ``settled``."""
    from torch.distributed.tensor import Partial, Shard
    K, ds = cfg.mamba_d_conv, cfg.mamba_d_state
    st = sh.state

    def stage_in(xl, w_in, cw, cb, wx, *conv):
        xl = contiguous_grad(xl)
        x1, z = sh.parts(xl @ w_in.to(xl.dtype), 2).unbind(-2)
        cs = conv[0].to(x1.dtype) if conv else torch.zeros(
            (xl.shape[0], K - 1, x1.shape[-1]), dtype=x1.dtype,
            device=xl.device)
        xc, new_conv = _causal_conv(x1, cw, cb, cs)
        xc = _silu32(xc).to(xl.dtype)
        return (xc @ wx.to(xc.dtype)).float(), xc, z, new_conv

    names_in = ("in_proj", "conv_w", "conv_b", "x_proj")
    conv = [st["conv"]] if st is not None else []
    proj, xc, z, new_conv = sh.run(
        stage_in, [sh.x, *(sh.w[n] for n in names_in), *conv],
        [sh.pl()] + [sh.wpl(n) for n in names_in] + [sh.pl(Shard(2))] *
        len(conv), [sh.pl(Partial())] + [sh.pl(Shard(2))] * 3,
        [sh.pl(Partial())] + [sh.wgrad(n) for n in names_in] +
        [sh.pl(Shard(2))] * len(conv))

    names_out = ("dt_proj", "dt_bias", "A_log", "D", "out_proj")

    def stage_scan(pj, xcl, zl, w_dt, b_dt, a_log, d_skip, w_out, *h0):
        xcl, zl = contiguous_grad(xcl), contiguous_grad(zl)
        pn = _ns(dt_proj=w_dt, dt_bias=b_dt, A_log=a_log, D=d_skip,
                 out_proj=w_out)
        A_bar, Bx, C_ssm = _ssm_inputs(cfg, pn, xcl, pj)
        h = h0[0].float() if h0 else torch.zeros(
            (xcl.shape[0], xcl.shape[-1], ds), dtype=F32, device=xcl.device)
        hs, hT = _scan_chunked(A_bar, Bx, h)
        return _mamba_out(pn, hs, C_ssm, xcl, zl), hT

    ssm_st = [st["ssm"]] if st is not None else []
    out, hT = sh.run(
        stage_scan, [proj, xc, z, *(sh.w[n] for n in names_out), *ssm_st],
        [sh.pl(), sh.pl(Shard(2)), sh.pl(Shard(2))] +
        [sh.wpl(n) for n in names_out] + [sh.pl(Shard(1))] * len(ssm_st),
        [sh.pl(Partial()), sh.pl(Shard(1))],
        [sh.pl(Partial()), sh.pl(Shard(2)), sh.pl(Shard(2))] +
        [sh.wgrad(n) for n in names_out] + [sh.pl(Shard(1))] * len(ssm_st))
    return out if train else (out, {"conv": new_conv, "ssm": hT})


def _mlstm(cfg, sh, train):
    """mLSTM over its rank's block of the head dim (w_q / w_k / w_v's
    output columns, C's key dim): up_proj's [xm | z] regrouped to the
    rank's block of d_inner by one all-to-all, xm gathered once (the
    q / k / v projections contract all of it) and the gates' partial
    sums reduced once.  Serving: v gathered once, the recurrence local,
    C q and n . q partial over the key blocks and summed once after the
    loop.  Training: q and k gathered once, the parallel form local over
    v's block, h gathered once.  The norm reads all of h; norm_w, z and
    down_proj are the rank's block of d_inner, down_proj's partial sum
    left to ``settled``.  The stabiliser m, one float a head, is read
    whole."""
    from torch.distributed.tensor import Partial, Shard
    di, nh, dh = _mlstm_dims(cfg)
    st, x = sh.state, sh.x
    B, S = x.shape[:2]
    dt = x.dtype

    def stage_in(xl, w_up, wi, wf):
        xl = contiguous_grad(xl)
        xm, z = sh.parts(xl @ w_up.to(xl.dtype), 2).unbind(-2)
        xf = xm.float()
        return xm, z, torch.cat([xf @ wi, xf @ wf], -1)

    names_in = ("up_proj", "w_i", "w_f")
    xm, z, gates = sh.run(
        stage_in, [x, *(sh.w[n] for n in names_in)],
        [sh.pl()] + [sh.wpl(n) for n in names_in],
        [sh.pl(Shard(2)), sh.pl(Shard(2)), sh.pl(Partial())],
        [sh.pl(Partial())] + [sh.wgrad(n) for n in names_in])

    names_qkv = ("w_q", "w_k", "w_v")

    def stage_qkv(xml, wq, wk, wv):
        return _mlstm_qkv(cfg, _ns(w_q=wq, w_k=wk, w_v=wv),
                          contiguous_grad(xml))

    q, k, v = sh.run(
        stage_qkv, [sh.whole(xm), *(sh.w[n] for n in names_qkv)],
        [sh.pl()] + [sh.wpl(n) for n in names_qkv], [sh.pl(Shard(3))] * 3,
        [sh.pl(Partial())] + [sh.wgrad(n) for n in names_qkv])
    gates = sh.whole(gates)
    b = [sh.w["b_i"], sh.w["b_f"]]
    b_pl = [sh.wpl("b_i"), sh.wpl("b_f")]
    b_grad = [sh.pgrad("b_i"), sh.pgrad("b_f")]
    if train:
        def stage_cell(ql, kl, vl, g, bi, bf):
            ql, kl, vl, g = (contiguous_grad(t) for t in (ql, kl, vl, g))
            pn = _ns(b_i=bi, b_f=bf)
            return _mlstm_parallel_h(ql, kl, vl,
                                     *_mlstm_gates(pn, *g.chunk(2, -1)))

        h = sh.run(stage_cell, [sh.whole(q), sh.whole(k), v, gates, *b],
                   [sh.pl(), sh.pl(), sh.pl(Shard(3)), sh.pl()] + b_pl,
                   [sh.pl(Shard(3))],
                   [sh.pl(Partial()), sh.pl(Partial()), sh.pl(Shard(3)),
                    sh.pl(Partial())] + b_grad)
        h = sh.whole(h)
        new = None
    else:
        m_pl = sh.pl()
        c_pl, n_pl = sh.pl(Shard(3)), sh.pl(Shard(2))

        def stage_cell(ql, kl, vw, g, bi, bf, *c):
            logi, logf = _mlstm_gates(_ns(b_i=bi, b_f=bf), *g.chunk(2, -1))
            qf, kf, vf = ql.float(), kl.float(), vw.float()
            if c:
                s0 = dict(zip(("C", "n", "m"), c))
            else:
                Bl, nk = qf.shape[0], kf.shape[-1]
                s0 = {"C": qf.new_zeros((Bl, nh, dh, nk)),
                      "n": qf.new_zeros((Bl, nh, nk)),
                      "m": qf.new_full((Bl, nh), -1e30)}

            def trip(t, s):
                num, nq, s = _mlstm_step_parts(qf[:, t], kf[:, t], vf[:, t],
                                               logi[:, t], logf[:, t], s)
                return (num, nq, s["m"]), s

            (num, nq, m), s = _loop(S, trip, s0)
            return (torch.cat([num.reshape(num.shape[:2] + (di,)), nq], -1),
                    m, s["C"], s["n"], s["m"])

        c = [st["C"], st["n"], st["m"]] if st is not None else []
        nd, m_t, C, n_st, m_st = sh.run(
            stage_cell, [q, k, sh.whole(v), gates, *b, *c],
            [sh.pl(Shard(3)), sh.pl(Shard(3)), sh.pl(), sh.pl()] + b_pl +
            ([c_pl, n_pl, m_pl] if c else []),
            [sh.pl(Partial()), sh.pl(), c_pl, n_pl, m_pl])
        nd = sh.whole(nd)
        num, nq = nd.split([di, nh], -1)
        den = torch.maximum(nq.abs(), torch.exp(-m_t))
        h = (num.unflatten(-1, (nh, dh)) / den[..., None]).flatten(-2)
        new = {"C": C, "n": n_st, "m": m_st}

    names_out = ("norm_w", "down_proj")
    lo = sh.rank * (di // sh.M)

    def stage_out(hw, zl, nw, wd):
        hw, zl = contiguous_grad(hw), contiguous_grad(zl)
        return _mlstm_out(cfg, _ns(norm_w=nw, down_proj=wd), hw, zl, lo)

    out = sh.run(stage_out, [h.reshape(B, S, di).to(dt), z,
                             *(sh.w[n] for n in names_out)],
                 [sh.pl(), sh.pl(Shard(2))] + [sh.wpl(n) for n in names_out],
                 [sh.pl(Partial())],
                 [sh.pl(Partial()), sh.pl(Shard(2))] +
                 [sh.wgrad(n) for n in names_out])
    return out if train else (out, new)


def _slstm(cfg, sh, train):
    """sLSTM over its rank's block of d.  The recurrent weight r is
    gathered once a layer (4 nh dh^2 float32: the recurrence contracts
    each head's whole h).  The decode step (one position after a state)
    runs the rank's channels: w_in's [i | f | z | o] columns regrouped
    to the block by one all-to-all, the recurrent term summed from every
    rank's block of h and scattered back by one reduce-scatter, h
    gathered once for the norm and ffn_up.  A recurrence over positions
    runs every channel on every rank (no collective inside the loop):
    x @ w_in gathered once, from zeros, or from the state gathered once
    (extend); the new state is the rank's block.  ffn_up and ffn_down
    are the rank's block of the FFN, ffn_down's partial sum left to
    ``settled``."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Shard
    d = cfg.d_model
    st, x = sh.state, sh.x
    dt = x.dtype
    n = d // sh.M
    lo = sh.rank * n
    keys = ("c", "h", "m", "n")
    r_whole, r_grad = sh.whole(sh.w["r"]), sh.pgrad("r")
    r_pl = list(r_whole.placements)
    names_out = ("norm_w", "ffn_up", "ffn_down")
    out_pl = [sh.wpl(n_) for n_ in names_out]
    out_grad = [sh.pgrad("norm_w"), sh.wgrad("ffn_up"),
                sh.wgrad("ffn_down")]

    def ffn(h, nw, wu, wdn):
        return _slstm_out(cfg, _ns(norm_w=nw, ffn_up=wu, ffn_down=wdn), h)

    if st is not None and x.shape[1] == 1:
        def stage_step(xl, w_in, r, b_in, *s):
            xin = sh.parts(xl[:, 0] @ w_in.to(xl.dtype), 4).float()
            s = dict(zip(keys, s))
            B, nh = xl.shape[0], cfg.n_heads
            hp = torch.zeros((B, d), dtype=F32, device=xl.device)
            hp[:, lo:lo + n] = s["h"]
            rec = torch.einsum("bnh,knhg->bkng", hp.reshape(B, nh, d // nh),
                               r).reshape(B, 4, d)
            rec = funcol.reduce_scatter_tensor(
                rec.movedim(-1, 0).contiguous(), "sum", 0,
                (sh.mesh, sh.mi)).movedim(0, -1)
            pre = xin + rec + b_in.reshape(4, d)[:, lo:lo + n]
            h, new = _slstm_cell(pre.reshape(B, 4 * n), s)
            return (h[:, None].to(dt), *(new[k_] for k_ in keys))

        outs = sh.run(stage_step, [x, sh.w["w_in"], r_whole, sh.w["b_in"],
                                   *(st[k_] for k_ in keys)],
                      [sh.pl(), sh.wpl("w_in"), r_pl, sh.wpl("b_in")] +
                      [sh.pl(Shard(1))] * 4,
                      [sh.pl(Shard(2))] + [sh.pl(Shard(1))] * 4)
        out = sh.run(ffn, [sh.whole(outs[0]),
                           *(sh.w[n_] for n_ in names_out)],
                     [sh.pl()] + out_pl, [sh.pl(Partial())])
        return out, dict(zip(keys, outs[1:]))

    xin = sh.whole(x @ sh.w["w_in"].to(dt))
    s_in = [sh.whole(st[k_]) for k_ in keys] if st is not None else []

    def stage_loop(xw, r, b_in, nw, wu, wdn, *s):
        xw = contiguous_grad(xw)
        s = dict(zip(keys, s)) if s else make_slstm_state(cfg, xw.shape[0],
                                                          xw.device)
        hs, s, _ = _slstm_loop(cfg, _ns(r=r, b_in=b_in), xw.float(), s)
        out = ffn(hs.to(dt), nw, wu, wdn)
        return (out, *(s[k_][:, lo:lo + n] for k_ in keys))

    args = [xin, r_whole, sh.w["b_in"], *(sh.w[n_] for n_ in names_out),
            *s_in]
    in_pl = [sh.pl(), r_pl, sh.wpl("b_in")] + out_pl + \
        [sh.pl()] * len(s_in)
    if train:
        grad = [sh.pl(Partial()), r_grad, sh.pgrad("b_in")] + out_grad
        return sh.run(lambda *a: stage_loop(*a)[0], args, in_pl,
                      [sh.pl(Partial())], grad)
    outs = sh.run(stage_loop, args, in_pl,
                  [sh.pl(Partial())] + [sh.pl(Shard(1))] * 4)
    return outs[0], dict(zip(keys, outs[1:]))
