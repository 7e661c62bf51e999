"""Edge-cloud channel model (paper §4; a copy of ``repro.core.channel``).

End-to-end latency per SD batch t:
    t_total = t_SLM(draft) + t_uplink(bits) + t_LLM(verify) [+ t_downlink]
The compute terms are measured (wall-clock) or modeled; the link terms
are bits / rate + per-message overhead.

Serving (``repro_torch.serve``) extends the single-stream model with
CONTENDED links: each radio cell's ingress is one shared uplink over
which every live request's per-round payload (packed ``wire.DraftPayload``
bytes) is serialised FIFO, and its egress is one shared broadcast
downlink carrying the packed verdicts the same way.  ``SharedUplink`` /
``SharedDownlink`` track the busy-until time of their link so each
transmission sees the queueing delay of the messages scheduled ahead of
it.  A zero-bit payload still occupies the link for
``per_msg_overhead_bits``; ``utilization`` over an empty or degenerate
window is 0.0, never NaN.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple


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


class Transmission(NamedTuple):
    start_s: float        # when the link starts serialising this payload
    end_s: float          # when the last bit leaves the edge
    arrive_s: float       # when it reaches the cloud (end + propagation)
    wait_s: float         # queueing delay behind earlier transmissions


class SharedLink:
    """FIFO contended link: one transmission occupies the wire for
        (bits + per_msg_overhead_bits) / rate_bps
    seconds; propagation (rtt/2) is added after serialisation and does
    not occupy the link.  ``transmit`` is called in scheduling order, so
    per-message ``wait_s`` is the head-of-line blocking each message
    experiences.  FIFO is the fairness contract the serving tests pin:
    a message's slot on the wire is fixed the moment ``transmit`` runs,
    so a later arrival — however large — can never displace it."""

    def __init__(self, ch: ChannelConfig, rate_bps: float):
        self.ch = ch
        self.rate_bps = rate_bps
        self.busy_until_s = 0.0
        self.busy_total_s = 0.0
        self.payload_bits_total = 0.0   # excludes per-message framing
        self.n_msgs = 0
        # backlog telemetry (read by obs.snapshot_topology): how often
        # and how badly messages queued behind earlier transmissions
        self.n_delayed = 0              # transmits with wait_s > 0
        self.peak_backlog_s = 0.0       # worst head-of-line wait seen

    def reset(self):
        self.busy_until_s = 0.0
        self.busy_total_s = 0.0
        self.payload_bits_total = 0.0
        self.n_msgs = 0
        self.n_delayed = 0
        self.peak_backlog_s = 0.0

    @property
    def bits_total(self) -> float:
        """Everything the wire carried: payloads plus one framing
        overhead per message."""
        return (self.payload_bits_total
                + self.n_msgs * self.ch.per_msg_overhead_bits)

    def transmit(self, now_s: float, bits: float) -> Transmission:
        assert bits >= 0.0, f"negative payload ({bits} bits)"
        start = max(now_s, self.busy_until_s)
        dur = (bits + self.ch.per_msg_overhead_bits) / self.rate_bps
        end = start + dur
        self.busy_until_s = end
        self.busy_total_s += dur
        self.payload_bits_total += bits
        self.n_msgs += 1
        wait = start - now_s
        if wait > 0.0:
            self.n_delayed += 1
            if wait > self.peak_backlog_s:
                self.peak_backlog_s = wait
        return Transmission(start, end, end + self.ch.rtt_s / 2, wait)

    def utilization(self, horizon_s: float) -> float:
        """Fraction of [0, horizon] the link spent serialising bits.
        An empty or degenerate window (zero load, zero horizon) is 0.0,
        never NaN."""
        if horizon_s <= 0:
            return 0.0
        return min(1.0, self.busy_total_s / horizon_s)


class SharedUplink(SharedLink):
    """The cell's contended edge→cloud ingress (DraftPayload bytes)."""

    def __init__(self, ch: ChannelConfig):
        super().__init__(ch, ch.uplink_bps)


class SharedDownlink(SharedLink):
    """The cell's shared cloud→edge broadcast (VerdictPayload bytes).

    Verdicts destined for the same cell serialise FIFO on this one
    carrier — per-verdict when verdict batching is off (each message
    pays ``per_msg_overhead_bits``), or as one coalesced coded frame
    per verify batch (``wire.pack_verdict_batch``) when it is on.  At
    broadcast rates far below the uplink this link, not the uplink, is
    the round's bottleneck."""

    def __init__(self, ch: ChannelConfig):
        super().__init__(ch, ch.downlink_bps)
