"""Edge-cloud uplink channel model (paper §4; a copy of the single-stream
part of ``repro.core.channel``).

End-to-end latency per SD batch t:
    t_total = t_SLM(draft) + t_uplink(bits) + t_LLM(verify) [+ t_downlink]
The compute terms are measured; the link terms are bits / rate +
per-message overhead.  The contended shared links of the serving layer
come with the serving slice.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    uplink_bps: float = 1e6          # 1 Mbit/s — constrained edge uplink
    downlink_bps: float = 20e6
    rtt_s: float = 0.02              # round-trip latency
    per_msg_overhead_bits: float = 256.0


def uplink_time(ch: ChannelConfig, bits) -> float:
    return (bits + ch.per_msg_overhead_bits) / ch.uplink_bps + ch.rtt_s / 2


def downlink_time(ch: ChannelConfig, bits) -> float:
    return (bits + ch.per_msg_overhead_bits) / ch.downlink_bps + ch.rtt_s / 2


def feedback_bits(L_max: int, vocab: int) -> float:
    """Cloud -> edge: accepted count + one token id."""
    return math.ceil(math.log2(L_max + 1)) + math.ceil(math.log2(vocab))
