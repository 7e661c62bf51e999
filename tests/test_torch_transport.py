"""The port's two-process serving against the reference's: the framing
layer byte for byte and error for error, torch TCP against the torch
simulator, and mixed sessions in both directions (a JAX EdgeClient
against a torch CloudServer, a torch EdgeClient against a JAX
CloudServer), each held to the reference simulator's streams with ``==``.

The smoke qwen2.5-3b pair and the seeded 2-cell trace of
tests/test_transport.py; every socket binds port 0 and carries a finite
timeout, so a wedged peer fails loud instead of hanging the suite.
"""
import functools
import logging
import socket
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core import EdgeCloudEngine as RefEngine  # noqa: E402
from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core import MethodConfig as RefMethodConfig  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import transport as ttp  # noqa: E402
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,  # noqa: E402
                                     MethodConfig)
from repro_torch.obs import (CLOCK_MODELED, CLOCK_WALL, Obs,  # noqa: E402
                             span_names_by_clock)
from repro_torch.serve.net import engine_digest  # noqa: E402

L_MAX = 3
IO_S = 30.0
ARCH = "qwen2.5-3b"
CSQS = dict(name="csqs", alpha=5e-3, eta=5e-2, use_kernels=False)
TRACE = dict(n_requests=4, rate_rps=12.0, prompt_len=8, min_new_tokens=4,
             max_new_tokens=7, vocab=512, seed=5, cells=2)
# (pipeline, codec, verdict batching): the two legs of the reference's
# tests/test_transport.py::test_tcp_streams_match_simulator
LEGS = [("lockstep", "v1", True), ("pipelined", "v2", False)]


def _serve_kw(pipeline, batch):
    return dict(max_batch=4, cache_len=48, n_cells=2, pipeline=pipeline,
                verdict_batch=batch)


# ======================================================================
# Framing: bytes and errors equal the reference's
# ======================================================================
class _Sink:
    """A socket stand-in that keeps what is sent."""

    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += b


class _Drip:
    """A socket stand-in that returns its bytes a few at a time, then EOF
    (TCP delivers a frame in pieces)."""

    def __init__(self, data, step=3):
        self.data, self.step = data, step

    def recv(self, n):
        chunk = self.data[:min(n, self.step)]
        self.data = self.data[len(chunk):]
        return chunk


def _sent(mod, msg_type, body):
    s = _Sink()
    mod.send_frame(s, msg_type, body)
    return s.data


FRAMES = [(ttp.MSG_HELLO, b'{"proto": 1}'),
          (ttp.MSG_VERIFY, bytes(range(256)) * 40),
          (ttp.MSG_BYE, b""), (ttp.MSG_STATS, b"{}")]


def test_constants_equal_reference():
    names = [n for n in dir(jtp) if n.startswith("MSG_")]
    assert names and all(getattr(ttp, n) == getattr(jtp, n) for n in names)
    assert (ttp.PROTO_VERSION, ttp.MAX_FRAME) == \
        (jtp.PROTO_VERSION, jtp.MAX_FRAME)


@pytest.mark.parametrize("msg_type,body", FRAMES,
                         ids=["hello", "verify", "bye", "stats"])
def test_frame_bytes_equal_reference(msg_type, body):
    data = _sent(ttp, msg_type, body)
    assert data == _sent(jtp, msg_type, body)
    # reassembled from partial reads, by both
    assert ttp.recv_frame(_Drip(data)) == jtp.recv_frame(_Drip(data)) == \
        (msg_type, body)


def test_body_bytes_equal_reference():
    rng = np.random.default_rng(3)
    items = [(int(s), rng.bytes(int(n)))
             for s, n in zip(rng.integers(0, 9, 5), rng.integers(0, 40, 5))]
    assert ttp.pack_verify_body(items) == jtp.pack_verify_body(items)
    assert ttp.unpack_verify_body(jtp.pack_verify_body(items)) == items
    for kw in (dict(verdicts=items), dict(frame=rng.bytes(33)),
               dict(verdicts=[])):
        body = ttp.pack_verdicts_body(0.0123, **kw)
        assert body == jtp.pack_verdicts_body(0.0123, **kw)
        assert ttp.unpack_verdicts_body(body) == \
            jtp.unpack_verdicts_body(body)
    prompt = np.arange(2, 12, dtype=np.int64)
    assert ttp.admit_body(1, 7, "v2", prompt) == \
        jtp.admit_body(1, 7, "v2", prompt)


def _framed(n, body):
    return struct.pack(">I", n) + body


# (function name, argument): malformed input for one transport function
BAD = [
    ("recv_frame", _framed(0, b"")),                       # zero length
    ("recv_frame", _framed(64 * 1024 * 1024 + 1, b"")),    # garbage length
    ("recv_frame", _framed(10, b"\x04abc")),               # EOF mid-body
    ("recv_frame", b"\x00\x00"),                           # EOF mid-header
    ("unpack_verify_body", b""),
    ("unpack_verify_body", b"\x00\x01\x00\x03"),           # truncated item
    ("unpack_verify_body", b"\x00\x01\x00\x03\x00\x00\x00\x09abc"),
    ("unpack_verify_body", b"\x00\x00junk"),               # trailing bytes
    ("unpack_verdicts_body", b"\x00" * 5),                 # short t_llm
    ("unpack_verdicts_body", b"\x00" * 8),                 # no mode byte
    ("unpack_verdicts_body", b"\x00" * 8 + b"\x02"),       # unknown mode
    ("unpack_verdicts_body", b"\x00" * 8 + b"\x01\x00\x00\x00\x05ab"),
    ("unpack_verdicts_body", b"\x00" * 8 + b"\x00\x00\x01\x00\x01"),
    ("unpack_verdicts_body", b"\x00" * 8 + b"\x00\x00\x00zz"),
    ("decode_json", b"{not json"),
    ("decode_json", b"\xff\xfe"),
    ("decode_json", b"[1, 2]"),
]


def _error_of(mod, fn, arg):
    f = getattr(mod, fn)
    try:
        f(_Drip(arg) if fn == "recv_frame" else arg)
    except Exception as e:                  # noqa: BLE001 — compared below
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", range(len(BAD)))
def test_malformed_input_raises_reference_error(case):
    fn, arg = BAD[case]
    got = _error_of(ttp, fn, arg)
    assert got is not None and got[0] == "TransportError", got
    assert got == _error_of(jtp, fn, arg)


def _tcp_pair():
    """Two connected TCP sockets on the loopback (``Conn`` sets
    TCP_NODELAY, which a Unix socket pair refuses)."""
    with socket.create_server(("127.0.0.1", 0)) as ls:
        a = socket.create_connection(ls.getsockname()[:2], timeout=IO_S)
        b, _ = ls.accept()
    return a, b


def test_recv_expect_surfaces_peer_error_and_wrong_type():
    results = []
    for mod in (ttp, jtp):
        out = []
        for kind, body in ((mod.MSG_ERROR, b'{"error": "nope"}'),
                           (mod.MSG_STATS, b"{}")):
            a, b = _tcp_pair()
            try:
                conn = mod.Conn(b, timeout_s=IO_S)
                mod.send_frame(a, kind, body)
                with pytest.raises(mod.TransportError) as e:
                    conn.recv_expect(mod.MSG_VERDICTS)
                out.append(str(e.value))
            finally:
                a.close()
                b.close()
        results.append(out)
    assert results[0] == results[1]
    assert "peer error: nope" in results[0][0]


# ======================================================================
# Sessions
# ======================================================================
@functools.lru_cache(maxsize=None)
def ref_pair():
    """The reference's smoke pair of tests/test_transport.py (target from
    PRNGKey(seed + 1), draft from PRNGKey(seed + 2), seed 0)."""
    tc = jconfigs.smoke_variant(jconfigs.get_config(ARCH))
    dc = jconfigs.draft_variant(tc, 2)
    return dc, init_params(dc, jax.random.PRNGKey(2)), tc, \
        init_params(tc, jax.random.PRNGKey(1))


def bridged_target(cfg, seed, device):
    """A torch server's target built from the reference's PRNGKey(seed)
    parameters: what a JAX edge's session expects."""
    jc = jconfigs.smoke_variant(jconfigs.get_config(ARCH))
    assert cfg.name == jc.name
    params = init_params(jc, jax.random.PRNGKey(seed))
    return bridge.from_jax(jax.tree.map(np.asarray, params), cfg,
                           device=device)


@functools.lru_cache(maxsize=None)
def torch_pair():
    """The port's own seeded pair (``bridge.seeded_model``, seed 0): what
    a torch server builds by default."""
    tc = configs.smoke_variant(configs.get_config(ARCH))
    dc = configs.draft_variant(tc, 2)
    return dc, bridge.seeded_model(dc, 2, "cpu"), tc, \
        bridge.seeded_model(tc, 1, "cpu")


def _streams(rep):
    return {r.rid: tuple(r.tokens) for r in rep.requests}


@functools.lru_cache(maxsize=None)
def ref_sim_streams(pipeline, codec, batch):
    dc, dp, tc, tp = ref_pair()
    eng = RefEngine(dc, dp, tc, tp, RefMethodConfig(**CSQS),
                    RefEngineConfig(L_max=L_MAX, wire_codec=codec), seed=0)
    rep = jserve.ServeSession(eng, jserve.ServeConfig(
        t_slm_s=0.01, t_llm_s=0.02, **_serve_kw(pipeline, batch))) \
        .run_trace(jserve.poisson_trace(jserve.TraceConfig(**TRACE)))
    return _streams(rep)


def _dial(server, mod):
    return mod.Conn(socket.create_connection((server.host, server.port),
                                             timeout=IO_S), timeout_s=IO_S)


@pytest.mark.parametrize("pipeline,codec,batch", LEGS,
                         ids=["lockstep-v1-batched", "pipelined-v2"])
def test_torch_tcp_equals_torch_simulator(pipeline, codec, batch):
    """A seeded 2-cell trace over real sockets between the port's client
    and server (default target builder) gives the port's simulator's
    streams, with obs live on both legs: modeled-clock round phases from
    the simulator, wall-clock draft / verify_rpc spans from the client,
    and the server's stats pulled at the end."""
    dc, dm, tc, tm = torch_pair()
    method, ecfg = MethodConfig(**CSQS), EngineConfig(L_max=L_MAX,
                                                      wire_codec=codec)
    obs = Obs.on()
    eng = EdgeCloudEngine(dc, dm, tc, tm, method, ecfg, seed=0,
                          device="cpu")
    sim = tserve.ServeSession(eng, tserve.ServeConfig(
        t_slm_s=0.01, t_llm_s=0.02, **_serve_kw(pipeline, batch)),
        obs=obs).run_trace(tserve.poisson_trace(tserve.TraceConfig(**TRACE)))
    server = tserve.CloudServer(device="cpu").start()
    try:
        client = tserve.EdgeClient(
            dc, dm, method, ecfg, tserve.ServeConfig(
                **_serve_kw(pipeline, batch)), arch=ARCH, smoke=True,
            host=server.host, port=server.port, seed=0, io_timeout_s=IO_S,
            session_id=f"torch-{pipeline}", obs=obs, device="cpu")
        with client:
            rep = client.run_trace(
                tserve.poisson_trace(tserve.TraceConfig(**TRACE)))
    finally:
        server.stop()
    assert rep.n_finished == TRACE["n_requests"]
    assert rep.streams() == _streams(sim)
    assert rep.rpc_round_s["n"] > 0 and rep.rpc_round_s["mean"] > 0.0
    names = span_names_by_clock(obs.tracer.chrome_trace())
    assert {"draft", "uplink", "verify", "downlink"} <= names[CLOCK_MODELED]
    assert {"draft", "verify_rpc"} <= names[CLOCK_WALL]
    c = rep.cloud_stats["counters"]
    assert c["cloud.verify_rpcs"] == rep.n_verify_rpcs > 0
    assert c.get("cloud.wire_decode_errors", 0) == 0


@pytest.mark.parametrize("pipeline,codec,batch", LEGS,
                         ids=["lockstep-v1-batched", "pipelined-v2"])
def test_jax_edge_against_torch_cloud(pipeline, codec, batch):
    """The reference's EdgeClient against the port's CloudServer, whose
    target is the reference's parameters through ``bridge.from_jax``:
    the reference simulator's streams."""
    dc, dp, _, _ = ref_pair()
    server = tserve.CloudServer(device="cpu",
                                build_target=bridged_target).start()
    try:
        client = jserve.EdgeClient(
            dc, dp, RefMethodConfig(**CSQS),
            RefEngineConfig(L_max=L_MAX, wire_codec=codec),
            jserve.ServeConfig(**_serve_kw(pipeline, batch)), arch=ARCH,
            smoke=True, host=server.host, port=server.port, seed=0,
            io_timeout_s=IO_S, session_id=f"jax-edge-{pipeline}")
        with client:
            rep = client.run_trace(
                jserve.poisson_trace(jserve.TraceConfig(**TRACE)))
    finally:
        server.stop()
    assert rep.n_finished == TRACE["n_requests"]
    assert rep.streams() == ref_sim_streams(pipeline, codec, batch)


@pytest.mark.parametrize("pipeline,codec,batch", LEGS,
                         ids=["lockstep-v1-batched", "pipelined-v2"])
def test_torch_edge_against_jax_cloud(pipeline, codec, batch):
    """The port's EdgeClient, drafting with the reference's draft
    parameters, against the reference's CloudServer: the reference
    simulator's streams."""
    _, dp, _, _ = ref_pair()
    tdc = configs.draft_variant(
        configs.smoke_variant(configs.get_config(ARCH)), 2)
    dm = bridge.from_jax(jax.tree.map(np.asarray, dp), tdc, device="cpu")
    server = jserve.CloudServer().start()
    try:
        client = tserve.EdgeClient(
            tdc, dm, MethodConfig(**CSQS),
            EngineConfig(L_max=L_MAX, wire_codec=codec),
            tserve.ServeConfig(**_serve_kw(pipeline, batch)), arch=ARCH,
            smoke=True, host=server.host, port=server.port, seed=0,
            io_timeout_s=IO_S, session_id=f"torch-edge-{pipeline}",
            device="cpu")
        with client:
            rep = client.run_trace(
                tserve.poisson_trace(tserve.TraceConfig(**TRACE)))
    finally:
        server.stop()
    assert rep.n_finished == TRACE["n_requests"]
    assert rep.streams() == ref_sim_streams(pipeline, codec, batch)


def test_handshake_rejects_mismatch_proto_codec_and_non_hello():
    """A later cell attaching to a live session with another config
    digest is rejected, as are a wrong protocol version, an unknown codec
    and a first frame that is not HELLO; the server keeps serving."""
    ecfg = EngineConfig(L_max=L_MAX)
    good = engine_digest(ARCH, True, MethodConfig(**CSQS), ecfg, seed=0,
                         n_slots=4, cache_len=48, verdict_batch=False)
    bad = dict(good, seed=1)
    server = tserve.CloudServer(device="cpu").start()
    try:
        conn = _dial(server, ttp)
        conn.send_json(ttp.MSG_HELLO, {"proto": ttp.PROTO_VERSION,
                                       "session": "s", "config": good})
        conn.recv_expect(ttp.MSG_HELLO_OK)
        for hello, match in (
                ({"proto": ttp.PROTO_VERSION, "session": "s",
                  "config": bad}, "mismatch"),
                ({"proto": ttp.PROTO_VERSION + 1, "session": "s",
                  "config": good}, "protocol version"),
                ({"proto": ttp.PROTO_VERSION, "session": "t",
                  "config": {"engine": {"wire_codec": "v99"}}},
                 "wire codec")):
            c = _dial(server, ttp)
            c.send_json(ttp.MSG_HELLO, hello)
            with pytest.raises(ttp.TransportError, match=match):
                c.recv_expect(ttp.MSG_HELLO_OK)
            c.close()
        c = _dial(server, ttp)
        c.send_json(ttp.MSG_ADMIT, {"slot": 0})
        with pytest.raises(ttp.TransportError, match="expected HELLO"):
            c.recv_expect(ttp.MSG_HELLO_OK)
        c.close()
        conn.send_json(ttp.MSG_STATS, {})
        snap = ttp.decode_json(conn.recv_expect(ttp.MSG_STATS))
        assert snap["counters"]["cloud.frames.hello"] == 1
        conn.send(ttp.MSG_BYE)
        conn.close()
    finally:
        server.stop()


def test_corrupt_verify_counted_logged_and_survived(caplog):
    """A corrupt draft payload inside a well-formed VERIFY frame bumps
    ``cloud.wire_decode_errors``, logs one error naming the peer and the
    frame type, reaches the peer as a wire-decode error, and leaves the
    server able to handshake and answer STATS."""
    digest = engine_digest(ARCH, True, MethodConfig(**CSQS),
                           EngineConfig(L_max=L_MAX), seed=0, n_slots=4,
                           cache_len=48, verdict_batch=False)
    server = tserve.CloudServer(device="cpu").start()
    try:
        def hello():
            c = _dial(server, ttp)
            c.send_json(ttp.MSG_HELLO, {"proto": ttp.PROTO_VERSION,
                                        "session": "decode-err", "cell": 0,
                                        "config": digest})
            c.recv_expect(ttp.MSG_HELLO_OK)
            return c

        conn = hello()
        conn.send_json(ttp.MSG_ADMIT, ttp.admit_body(
            0, seed=0, wire_codec=None, prompt=range(2, 10)))
        with caplog.at_level(logging.ERROR, logger="repro_torch.serve.net"):
            conn.send(ttp.MSG_VERIFY, ttp.pack_verify_body([(0, b"")]))
            with pytest.raises(ttp.TransportError, match="wire decode"):
                conn.recv_expect(ttp.MSG_VERDICTS)
        conn.close()
        msgs = [r.getMessage() for r in caplog.records
                if r.name == "repro_torch.serve.net"
                and r.levelno == logging.ERROR]
        assert any("wire decode error from 127.0.0.1:" in m
                   and "verify frame" in m for m in msgs), msgs
        conn2 = hello()
        conn2.send_json(ttp.MSG_STATS, {})
        snap = ttp.decode_json(conn2.recv_expect(ttp.MSG_STATS))
        c = snap["counters"]
        assert (c["cloud.wire_decode_errors"], c["cloud.frames.verify"],
                c["cloud.frames.admit"], c["cloud.frames.hello"]) == \
            (1, 1, 1, 2)
        conn2.send(ttp.MSG_BYE)
        conn2.close()
    finally:
        server.stop()
