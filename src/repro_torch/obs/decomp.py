"""Online Theorem-1 rejection decomposition + conformal coverage
(mirrors ``repro.obs.decomp``).

The paper's Theorem 1 bounds each token's rejection probability by
three additive terms (``core.theory.thm1_terms``):

    mismatch    TV(q, p)        — SLM-LLM model discrepancy: rejections
                                  sparsification/quantization did NOT
                                  cause (irreducible without a better
                                  draft model);
    dropped     alpha_n(X_n)    — the conformal sparsifier's dropped
                                  mass (truncation distortion);
    lattice     K_n / (4 l_n)   — lattice quantization distortion.

``DecompTracker.observe_round`` turns one ``run_round`` metrics dict
into a per-round record of those terms summed over the round's LIVE
draft positions, alongside the exact rejection mass TV(q_hat, p) and
the bound total from ``thm1_bound_total`` — so a serving run shows
online WHERE its rejections come from: model mismatch vs the
truncation+quantization the wire budget bought.

The dense per-position arrays exist only under
``EngineConfig.collect_theory``; without them the tracker still records
the light per-round telemetry (mean dropped mass, beta) so coverage
tracking works in every mode.

Conformal coverage (paper Theorem 2): the tracker accumulates the
empirical mean dropped mass over all observed draft positions and
reports its deviation from the alpha target next to the finite-horizon
Theorem-2 bound, plus the beta trajectory envelope — whether the
eq. (8) controller is actually tracking its target online.

Everything here READS host-side metrics dicts; nothing touches engine
state, PRNG keys or tokens — observability on vs off is bit-identical
by construction.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import conformal
from repro_torch.core.theory import thm1_bound_total, thm1_terms

__all__ = ["DecompTracker"]


class DecompTracker:
    def __init__(self, alpha: float, eta: float, ell: int,
                 beta0: float = 1e-3):
        self.alpha = float(alpha)
        self.eta = float(eta)
        self.ell = int(ell)
        self.beta0 = float(beta0)
        self.rounds: List[dict] = []
        self._dropped_sum = 0.0       # sum of alpha_n over live positions
        self._n_positions = 0
        self._beta_min = float("inf")
        self._beta_max = float("-inf")

    # ------------------------------------------------------------------
    def observe_round(self, m: dict) -> Optional[dict]:
        """Record one ``EdgeCloudEngine.run_round`` metrics dict.
        Returns the per-round record (None when no slot was active)."""
        active = np.asarray(m["active"], bool)
        if not active.any():
            return None
        rec = {"round": len(self.rounds),
               "n_slots": int(active.sum()),
               "n_accept": int(np.asarray(m["n_accept"]).sum())}
        beta_row = m.get("beta_row")
        if beta_row is not None:
            b = np.asarray(beta_row, np.float64)[active]
            rec["beta_mean"] = float(b.mean())
            self._beta_min = min(self._beta_min, float(b.min()))
            self._beta_max = max(self._beta_max, float(b.max()))
        if "q" in m:
            self._observe_theory(m, rec)
        else:
            # light mode (no collect_theory): approximate coverage from
            # the round's mean dropped mass and its live position count
            n_pos = int(np.asarray(m["L_live"])[active].sum())
            rec["n_positions"] = n_pos
            rec["dropped_mean"] = float(m["dropped_mean"])
            self._dropped_sum += rec["dropped_mean"] * n_pos
            self._n_positions += n_pos
        self.rounds.append(rec)
        return rec

    def _observe_theory(self, m: dict, rec: dict):
        """Full decomposition from the dense collect_theory arrays,
        restricted to the LIVE (actually transmitted) positions."""
        live = np.asarray(m["live_seq"], bool)              # (B, L)
        L = live.shape[1]
        q = np.asarray(m["q"])[live]                        # (N, V)
        q_hat = np.asarray(m["q_hat"])[live]
        p = np.asarray(m["p"])[:, :L][live]
        dropped = np.asarray(m["dropped_seq"])[:, :L][live]
        K = np.asarray(m["K_seq"])[live]
        terms = thm1_terms(q, p, q_hat, dropped, K, self.ell)
        exact, ub = thm1_bound_total(terms)
        rec.update({
            "n_positions": int(live.sum()),
            "mismatch": float(terms.mismatch.double().sum()),
            "dropped": float(terms.dropped.double().sum()),
            "lattice": float(terms.lattice.double().sum()),
            "bound": float(ub),
            "exact": float(exact),
        })
        # distortion split the panels plot: what the wire budget caused
        # (truncation + quantization) vs what it did not (mismatch)
        rec["distortion"] = rec["dropped"] + rec["lattice"]
        self._dropped_sum += rec["dropped"]
        self._n_positions += rec["n_positions"]

    # ------------------------------------------------------------------
    def coverage(self) -> dict:
        """Empirical conformal coverage vs the alpha target, with the
        finite-horizon Theorem-2 bound at the observed position count."""
        n = self._n_positions
        mean_dropped = self._dropped_sum / n if n else 0.0
        bound = float(conformal.thm2_bound(self.alpha, self.eta,
                                           self.beta0, max(n, 1)))
        lo, hi = conformal.beta_envelope(self.alpha, self.eta)
        return {
            "alpha": self.alpha,
            "n_positions": n,
            "mean_dropped": mean_dropped,
            "deviation": mean_dropped - self.alpha,
            "thm2_bound": bound,
            "within_thm2": bool(mean_dropped <= bound + 1e-9),
            "beta_min": self._beta_min if n else 0.0,
            "beta_max": self._beta_max if n else 0.0,
            "beta_envelope": [float(lo), float(hi)],
        }

    def reconcile(self, atol: float = 1e-4) -> Tuple[bool, float]:
        """Check every full-telemetry round against the analytic
        decomposition: mismatch + dropped + lattice must equal the
        ``thm1_bound_total`` upper bound, and the exact rejection mass
        must not exceed it.  Returns (ok, max_abs_error)."""
        err = 0.0
        ok = True
        n_full = 0
        for rec in self.rounds:
            if "bound" not in rec:
                continue
            n_full += 1
            gap = abs(rec["mismatch"] + rec["dropped"] + rec["lattice"]
                      - rec["bound"])
            err = max(err, gap)
            if gap > atol or rec["exact"] > rec["bound"] + atol:
                ok = False
        return ok and n_full > 0, err

    def snapshot(self) -> dict:
        return {"alpha": self.alpha, "eta": self.eta, "ell": self.ell,
                "n_rounds": len(self.rounds),
                "coverage": self.coverage(),
                "rounds": list(self.rounds)}
