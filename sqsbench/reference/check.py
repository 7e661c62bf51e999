"""Judge served requests against the plain reference.

For each request the reference runs both models in float32 over the
prompt and the tokens the system served, once, and reads every round the
system ran for it from the bytes it put on the wire (``reference.wire``):

* draft side, at every drafted position whose prefix the verdict kept:
  the lattice counts must be a monotone function of the reference's
  logits (a token given more of the ell units cannot sit lower), K-SQS's
  counted tokens must lie in the reference's top K and C-SQS's at or
  above the threshold the payload carries (or be the row's most probable
  token, which C-SQS keeps whatever its probability), and the draft token must be
  the arg-max of log q-hat plus the request's Gumbel noise.  Each reads
  as a gap in logits (0 where the system is exact);
* cloud side, in every round: each accept decision against the
  reference's target probability with the request's uniforms, and the
  resampled or bonus token against the reference's residual (or target)
  distribution with the request's Gumbel noise, as the widest gap in
  log-probability by which the served choice lies below the best;
* the emitted tokens must be the accepted drafts and the verdict's token,
  and every payload must decode whole (no bytes past its last field,
  counts summing to ell, a K-SQS support of at most K tokens).

``control`` reads the same numbers for the reference itself computed
with float8 weights in the system's place, on the same prompts, tokens
and payloads: the decisions the lower precision puts first, judged by
the float32 reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from reference import decoder, prng, sqs, wire

BROKEN = 1e9          # a served stream that contradicts its own verdicts


@dataclasses.dataclass
class Served:
    """One request as the system served it."""
    prompt: np.ndarray                   # token ids
    seed: int                            # the seed handed to the system
    rounds: List[tuple]                  # (draft bytes, verdict bytes, emitted)


def _alloc_gap(z, b):
    """Widest logit gap by which a token holding fewer lattice units sits
    above one holding more (0 for counts monotone in z)."""
    gap = 0.0
    for c in torch.unique(b[b > 0]).tolist():
        hi = z[b >= c].min()
        lo = z[b < c]
        if lo.numel():
            gap = max(gap, float(lo.max() - hi))
    return gap


def _level_gap(z, q, b, method, K, beta):
    held = b > 0
    if method == "ksqs":
        zk = torch.topk(z, min(K, z.numel())).values[-1]
        return max(0.0, float(zk - z[held].min()))
    if beta <= 0:
        return 0.0
    # a held token below beta is owed only as the row's most probable one,
    # which C-SQS always keeps: it reads as its logit gap to the best
    below = math.log(beta) - _log(q[held])
    to_best = z.max() - z[held]
    return max(0.0, float(torch.minimum(below, to_best).max()))


def _choice_gap(logd, g, tok):
    s = logd + g
    return float(s.max() - s[tok])


def _log(x):
    return torch.log(torch.clamp(x, min=1e-30))


class _Judge:
    """Running widest gaps of one side (the system or the control)."""

    def __init__(self):
        self.draft = 0.0
        self.verify = 0.0
        self.steps = 0
        self.rounds = 0

    def verified(self, gap: float):
        self.verify = max(self.verify, gap)
        self.rounds += 1

    def out(self):
        return {"draft_gap": self.draft, "verify_gap": self.verify,
                "draft_steps": self.steps, "verify_rounds": self.rounds}


@torch.no_grad()
def judge(pair: dict, W: Dict[str, Dict[str, torch.Tensor]], method: dict,
          engine: dict, served: List[Served], device,
          with_control: bool = False) -> dict:
    """Readings of the system (and of the control) over ``served``."""
    ecfg, ccfg = pair["edge"], pair["cloud"]
    V, ell, L = ecfg["vocab"], method["ell"], engine["L_max"]
    name, K = method["name"], method["K"]
    alpha, eta = method["alpha"], method["eta"]
    inv_t = 1.0 / max(float(np.float32(engine["temperature"])), 1e-4)
    inv_ell = float(np.float32(1.0) / np.float32(ell))
    sides = {"system": _Judge()}
    casts = {"system": decoder.exact}
    if with_control:
        sides["control"] = _Judge()
        casts["control"] = decoder.control
    for req in served:
        try:
            drafts = [wire.decode_draft(r[0], V, ell, L) for r in req.rounds]
            verdicts = [wire.decode_verdict(r[1], V, L) for r in req.rounds]
        except ValueError:
            j = sides["system"]
            j.draft = j.verify = BROKEN
            continue
        emitted = [list(r[2]) for r in req.rounds]
        S0 = len(req.prompt)
        seq = np.concatenate([req.prompt, np.concatenate(emitted)])
        tokens = torch.as_tensor(seq[:-1], dtype=torch.int64, device=device)
        # positions each round reads: pos_r + k for k <= T_r
        starts, pos = [], S0 - 1
        for e in emitted:
            starts.append(pos)
            pos += len(e)
        idx = sorted({s + k for s, v in zip(starts, verdicts)
                      for k in range(v.n_accept + 1)})
        row = {p: i for i, p in enumerate(idx)}
        it = torch.as_tensor(idx, device=device)
        z = {}
        for side, cast in casts.items():
            he = decoder.hidden(ecfg, W["edge"], tokens, cast)[it]
            hc = decoder.hidden(ccfg, W["cloud"], tokens, cast)[it]
            z[side] = (decoder.logits(ecfg, W["edge"], he, cast) * inv_t,
                       decoder.logits(ccfg, W["cloud"], hc, cast) * inv_t)
            del he, hc
        ze_ref, zc_ref = z["system"]
        ekeys, ckeys = prng.EdgeKeys(req.seed), prng.CloudKeys(req.seed)
        beta_sys = beta_ctl = float(np.float32(method["beta0"]))
        for r, (d, v, e, s) in enumerate(zip(drafts, verdicts, emitted,
                                             starts)):
            n, T = len(d.tokens), v.n_accept
            sysj = sides["system"]
            if T > n or e != d.tokens[:T] + [v.token] or (
                    name == "ksqs" and any(len(x) > K for x in d.supports)):
                sysj.draft = sysj.verify = BROKEN
            step_keys = ekeys.round_steps(min(T, n - 1) + 1)
            qhat = torch.zeros((n + 1, V), device=device)
            for k in range(n):
                b = torch.zeros(V, device=device)
                b[torch.as_tensor(d.supports[k], device=device)] = \
                    torch.as_tensor(d.counts[k], dtype=torch.float32,
                                    device=device)
                qhat[k] = b * inv_ell
            # --- draft side: positions whose prefix the verdict kept ---
            for k in range(min(T, n - 1) + 1):
                zr = ze_ref[row[s + k]]
                qr = torch.softmax(zr, -1)
                b = torch.round(qhat[k] / inv_ell)
                beta_used = beta_sys if k == 0 else float(d.betas[k - 1])
                g = prng.gumbel(step_keys[k], V, device)
                gap = max(_alloc_gap(zr, b),
                          _level_gap(zr, qr, b, name, K, beta_used),
                          _choice_gap(_log(qhat[k]), g, d.tokens[k]))
                sysj.draft = max(sysj.draft, gap)
                sysj.steps += 1
                if "control" in sides:
                    zc = z["control"][0][row[s + k]]
                    bc, dropped = sqs.sqs(torch.softmax(zc, -1), name, K,
                                          beta_ctl, ell)
                    cj = sides["control"]
                    cj.draft = max(cj.draft, _alloc_gap(zr, bc),
                                   _level_gap(zr, qr, bc, name, K, beta_ctl))
                    cj.steps += 1
                    beta_ctl = sqs.beta_update(beta_ctl, dropped, alpha, eta)
            if name == "csqs":
                beta_sys = float(v.beta)
            # --- cloud side ---
            ku, kg = ckeys.next_round()
            u = torch.from_numpy(prng.uniform(ku, L, 1e-12, 1.0)).to(device)
            g = prng.gumbel(kg, V, device)
            for side, j in sides.items():
                zc_side = z[side][1]
                gap = 0.0
                for k in range(min(T, n - 1) + 1 if n else 1):
                    if k >= n:
                        break
                    p_ref = torch.softmax(zc_ref[row[s + k]], -1)
                    p_side = torch.softmax(zc_side[row[s + k]], -1)
                    tok = d.tokens[k]
                    qd = max(float(qhat[k, tok]), 1e-30)
                    ratio_ref = min(1.0, float(p_ref[tok]) / qd)
                    ratio_side = min(1.0, float(p_side[tok]) / qd)
                    took = k < T if side == "system" else \
                        float(u[k]) < ratio_side
                    lu = math.log(float(u[k]))
                    lr = math.log(max(ratio_ref, 1e-45))
                    gap = max(gap, lu - lr if took else lr - lu)
                p_ref = torch.softmax(zc_ref[row[s + T]], -1)
                p_side = torch.softmax(zc_side[row[s + T]], -1)
                rejected = T < n
                dist_ref, dist_side = p_ref, p_side
                if rejected:
                    res_ref = torch.clamp(p_ref - qhat[T], min=0.0)
                    res_side = torch.clamp(p_side - qhat[T], min=0.0)
                    if float(res_ref.sum()) > 1e-30:
                        dist_ref = res_ref / res_ref.sum()
                    if float(res_side.sum()) > 1e-30:
                        dist_side = res_side / res_side.sum()
                lr = _log(dist_ref)
                pick = v.token if side == "system" else \
                    int(torch.argmax(_log(dist_side) + g))
                j.verified(max(gap, _choice_gap(lr, g, pick)))
        del z, ze_ref, zc_ref
    return {side: j.out() for side, j in sides.items()}
