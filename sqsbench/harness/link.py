"""The radio cell's modeled link: one shared uplink and one shared
broadcast downlink, each carrying a round's messages FIFO.  A message
holds the wire for (bits + framing) / rate seconds and arrives rtt / 2
after its last bit.  A lockstep round waits for its last payload to
arrive before the verify and for its last verdict after it, so its link
time is the sum of both queues plus two half round trips.  The rates and
the framing are written into each traffic file; this arithmetic is the
benchmark's own, so a change to the system's channel model does not move
the yardstick."""
from __future__ import annotations

from typing import Iterable


def queue_s(bits: Iterable[float], rate_bps: float, framing_bits: float,
            rtt_s: float) -> float:
    """Arrival of the last of ``bits`` sent together on one FIFO link."""
    return sum(b + framing_bits for b in bits) / rate_bps + rtt_s / 2


def round_link_s(link: dict, up_bits: Iterable[float],
                 down_bits: Iterable[float]) -> float:
    """The modeled link time of one lockstep round."""
    fr, rtt = link["per_msg_overhead_bits"], link["rtt_s"]
    return (queue_s(up_bits, link["uplink_bps"], fr, rtt)
            + queue_s(down_bits, link["downlink_bps"], fr, rtt))
