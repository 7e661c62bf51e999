"""Poisson arrival traces for the serving driver and load benchmark.

Arrivals are homogeneous Poisson processes (exponential interarrivals at
``rate_rps``); prompts come from the SyntheticLM corpus so the draft and
target models see in-distribution text; per-request generation lengths
are uniform in [min_new_tokens, max_new_tokens].  Everything is seeded:
the same TraceConfig always yields the same workload, so continuous and
static batching are compared on identical arrivals.

Multi-cell serving (``cells > 1``): each radio cell is its OWN arrival
process — an independent Poisson stream at ``rate_rps`` per cell, with
the cell's requests tagged ``Request.cell`` — because users in
different cells are different populations, not one queue split in two.
The merged trace is sorted by arrival time and rids follow that global
order, so per-request seeds depend only on the request's place in the
merged workload.  ``cells == 1`` reproduces the historical single-cell
trace bit-for-bit (same RNG draw order).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.serve.request import Request


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_requests: int = 16
    rate_rps: float = 2.0           # mean arrival rate (requests/s, PER CELL)
    prompt_len: int = 12            # fixed → one prefill compile
    min_new_tokens: int = 8
    max_new_tokens: int = 32
    vocab: int = 512
    eos_id: Optional[int] = None    # None: length-only termination
    seed: int = 0
    cells: int = 1                  # independent per-cell Poisson processes


def _arrival_cells(cfg: TraceConfig, rng) -> List[tuple]:
    """(t_arrival, cell) pairs, merged across the per-cell processes and
    sorted by time (cell id breaks exact ties deterministically).  With
    one cell this degenerates to a single exponential draw over an
    already-sorted cumsum — the historical trace, same RNG stream.
    n_requests is split as evenly as possible; earlier cells take the
    remainder.  Each cell draws its OWN exponential stream (in cell
    order, so the draw sequence is pinned by the config alone)."""
    per = [cfg.n_requests // cfg.cells
           + (1 if c < cfg.n_requests % cfg.cells else 0)
           for c in range(cfg.cells)]
    pairs = []
    for c, n_c in enumerate(per):
        gaps = rng.exponential(1.0 / max(cfg.rate_rps, 1e-9), n_c)
        pairs.extend((float(t), c) for t in np.cumsum(gaps))
    return sorted(pairs)


def poisson_trace(cfg: TraceConfig) -> List[Request]:
    rng = np.random.default_rng(cfg.seed)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seed=cfg.seed + 101))
    arrivals = _arrival_cells(cfg, rng)
    prompts = data.sample(cfg.n_requests, cfg.prompt_len)[:, :-1]
    lens = rng.integers(cfg.min_new_tokens, cfg.max_new_tokens + 1,
                        cfg.n_requests)
    return [
        Request(rid=i,
                prompt=prompts[i].astype(np.int32),
                t_arrival=arrivals[i][0],
                max_new_tokens=int(lens[i]),
                eos_id=cfg.eos_id,
                seed=cfg.seed + 1000 + i,
                cell=arrivals[i][1])
        for i in range(cfg.n_requests)
    ]
