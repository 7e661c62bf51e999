"""Request lifecycle for SQS-SD serving.

A request is one edge user's generation job: it arrives (Poisson trace or
API call), waits in the admission queue, occupies an engine slot while
decoding (prefill → SD rounds → EOS/length completion), and leaves.  All
timestamps are on the serving clock (seconds, virtual time): modeled
channel + measured compute, see serve.session.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"          # arrived, waiting for a slot
    ACTIVE = "active"          # occupying an engine slot
    FINISHED = "finished"      # EOS or max_new_tokens reached
    REJECTED = "rejected"      # admission queue full on arrival


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S0,) int32, S0 >= 2
    t_arrival: float                   # seconds on the serving clock
    max_new_tokens: int = 64
    eos_id: Optional[int] = None       # None: length-only termination
    seed: int = 0                      # per-request RNG root (engine.row_key)
    wire_codec: Optional[str] = None   # per-request codec version override
                                       # (None: the link's negotiated default)
    cell: int = 0                      # radio cell the edge device sits in
                                       # (topology maps it mod n_cells, so a
                                       # trace replays under ANY cell count)

    # -- runtime state (owned by the scheduler/session) ----------------
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    uplink_wait_s: float = 0.0         # total head-of-line blocking
    n_rounds: int = 0
    n_preempts: int = 0                # times evicted on page exhaustion

    def add_tokens(self, new_tokens, now: float) -> bool:
        """Append one round's emitted tokens; truncate at EOS or the
        length limit.  Returns True when the request just finished."""
        assert self.state == RequestState.ACTIVE
        if new_tokens and self.t_first_token is None:
            self.t_first_token = now
        done = False
        for t in new_tokens:
            if self.eos_id is not None and t == self.eos_id:
                self.tokens.append(t)
                done = True
                break
            self.tokens.append(t)
            if len(self.tokens) >= self.max_new_tokens:
                done = True
                break
        return done

    # -- derived metrics ------------------------------------------------
    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_arrival

    @property
    def latency_s(self) -> Optional[float]:
        """Arrival → completion (the percentile the report quotes)."""
        if self.t_finish is None:
            return None
        return self.t_finish - self.t_arrival

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_arrival
