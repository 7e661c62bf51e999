"""The benchmark's copy of the link arithmetic against the system's
channel model (``repro_torch.core.channel``)."""
import pytest

from harness import link
from repro_torch.core import channel

LINK = {"uplink_bps": 1e6, "downlink_bps": 2e7, "rtt_s": 0.02,
        "per_msg_overhead_bits": 256.0}


def test_one_message_is_the_channel_formula():
    ch = channel.ChannelConfig()
    for bits in (0.0, 1000.0, 8448.0):
        assert link.queue_s([bits], LINK["uplink_bps"], 256.0, 0.02) == \
            pytest.approx(channel.uplink_time(ch, bits))
        assert link.queue_s([bits], LINK["downlink_bps"], 256.0, 0.02) == \
            pytest.approx(channel.downlink_time(ch, bits))


@pytest.mark.parametrize("bits", [[800.0] * 64, [2400.0, 10.0, 9000.0],
                                  [0.0]])
def test_fifo_queue_is_the_shared_link(bits):
    ch = channel.ChannelConfig()
    up, down = channel.SharedUplink(ch), channel.SharedDownlink(ch)
    last_up = max(up.transmit(0.0, b).arrive_s for b in bits)
    last_down = max(down.transmit(0.0, b).arrive_s for b in bits)
    assert link.round_link_s(LINK, bits, bits) == \
        pytest.approx(last_up + last_down)
