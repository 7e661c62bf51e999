"""Two-process socket serving: CloudServer + EdgeClient over
``core.transport`` (mirrors ``repro.serve.net``; either end talks to the
reference's other end).

The simulator (``serve.session`` / ``serve.events``) models the clock;
this module replaces it with real TCP while keeping every token-
affecting step in code SHARED with the simulator:

  * ``EdgeTransportEngine`` extends ``core.engine.EdgeEngineBase`` —
    the same drafting / speculation / verdict application the
    in-process ``EdgeCloudEngine`` runs, with the verify peer reached
    through a socket instead of an attribute;
  * both runners drive ``serve.events.RoundStateMachine`` — the same
    admission/draft/speculate/apply logic the pipelined simulator uses;
  * the cloud side is the same ``CloudVerifyEngine``; masked-subset
    equivalence plus the replay registers make its verdicts independent
    of how VERIFY calls group slots, so per-connection RPCs equal the
    simulator's single batched verify.

That is why the differential oracle holds: the same seeded trace over
sockets yields BIT-IDENTICAL token streams to the simulator, while all
latency here is MEASURED wall-clock (draft compute, RPC round trips,
the server's verify time riding back in each VERDICTS reply) rather
than modeled.

Topology mirrors the simulator's cells: one TCP connection per radio
cell (the per-cell ``SharedLink`` isolation becomes per-cell sockets),
every cell of one logical session attaching to ONE
``CloudVerifyEngine`` on the server.
The session handshake carries the full arch/smoke/method/engine config
digest; both processes independently build identical models from
(arch, smoke, seed) — parameters never cross the wire, exactly like
the launch convention (target from seed+1, draft from seed+2: here a
``torch.Generator`` on each process's device, ``bridge.seeded_model``).
A torch process and a JAX process draw different weights from the same
seed, so a mixed session hands the torch end the reference's parameters
(``CloudServer``'s ``build_target``, ``EdgeClient``'s draft model).

Scope: dense slots (no paged pool — the allocator mirror would need
its own sync protocol) and attention-only decoder models (per-slot
verdict application is the stateless path; an encoder-decoder target is
refused at the handshake, before it is built, with
``core.engine.EncoderDecoderServingError``).  Arrival replay submits the whole
trace up front in arrival order — real sockets have no virtual clock
to pause — so each cell's arrival count must fit its waiting room
(asserted); admission order, and therefore every stream, is unchanged
because per-request determinism never depended on WHEN a request was
admitted.
"""
from __future__ import annotations

import dataclasses
import logging
import selectors
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import seeded_model
from repro_torch.core import channel as channel_mod
from repro_torch.core import transport as tp_mod
from repro_torch.core import wire as wire_mod
from repro_torch.core.engine import (CloudVerifyEngine, EdgeEngineBase,
                                     EngineConfig, MethodConfig,
                                     check_servable, is_stateful)
from repro_torch.core.transport import (MSG_ADMIT, MSG_BYE, MSG_ERROR,
                                        MSG_HELLO, MSG_HELLO_OK, MSG_STATS,
                                        MSG_VERDICTS, MSG_VERIFY,
                                        PROTO_VERSION, Conn, TransportError)
from repro_torch.obs import (CLOCK_WALL, NULL_OBS, MetricsRegistry, Obs,
                             summary_stats)
from repro_torch.serve.cells import CellTopology
from repro_torch.serve.events import RoundStateMachine
from repro_torch.serve.request import Request

IO_TIMEOUT_S = 120.0
TCP_TARGET_REFUSAL = "tcp transport serves attention-only target models"
TCP_DRAFT_REFUSAL = "tcp transport serves attention-only draft models"

log = logging.getLogger("repro_torch.serve.net")

_MSG_NAMES = {MSG_HELLO: "hello", MSG_HELLO_OK: "hello_ok",
              MSG_ADMIT: "admit", MSG_VERIFY: "verify",
              MSG_VERDICTS: "verdicts", MSG_ERROR: "error",
              MSG_BYE: "bye", MSG_STATS: "stats"}


def _msg_name(kind: int) -> str:
    return _MSG_NAMES.get(kind, f"unknown_{kind}")


def engine_digest(arch: str, smoke: bool, method: MethodConfig,
                  engine: EngineConfig, seed: int, n_slots: int,
                  cache_len: int, verdict_batch: bool) -> dict:
    """The config both processes must agree on, as one JSON-able dict.
    The server rebuilds its target model and engine from this alone; a
    later cell connecting with ANY differing field is rejected."""
    return {
        "arch": arch, "smoke": bool(smoke), "seed": int(seed),
        "method": dataclasses.asdict(method),
        "engine": dataclasses.asdict(engine),
        "n_slots": int(n_slots), "cache_len": int(cache_len),
        "verdict_batch": bool(verdict_batch),
    }


# ======================================================================
# Server
# ======================================================================
class _Session:
    """One logical serving session: the shared cloud engine plus the
    lock serialising engine calls across its per-cell connections.  The
    target model comes from ``build_target(cfg, seed + 1, device)``."""

    def __init__(self, config: dict, device: torch.device,
                 build_target: Callable):
        from repro_torch import configs

        self.config = config
        tc = configs.get_config(config["arch"])
        if config["smoke"]:
            tc = configs.smoke_variant(tc)
        method = MethodConfig(**config["method"])
        engine = EngineConfig(**config["engine"])
        seed = config["seed"]
        fmt = wire_mod.WireFormat(
            V=tc.vocab, ell=method.ell, L_max=engine.L_max,
            mode="raw" if method.name == "uncompressed" else "lattice",
            codec=engine.wire_codec)
        if is_stateful(tc):
            raise TransportError(TCP_TARGET_REFUSAL)
        # before the target is built: an encoder-decoder target is
        # refused by name (a sliding-window target's ring takes its spare
        # from the HELLO's L_max, in CloudVerifyEngine.init_slots)
        check_servable(tc)
        self.cloud = CloudVerifyEngine(tc, build_target(tc, seed + 1, device),
                                       method, engine, fmt, seed, device)
        self.cloud.init_slots(config["n_slots"], config["cache_len"], None)
        self.fmt = fmt
        self.n_slots = config["n_slots"]
        self.verdict_batch = config["verdict_batch"]
        self.lock = threading.Lock()


class CloudServer:
    """Streaming accept loop fronting ``CloudVerifyEngine``: one thread
    per connection (= per cell), sessions created lazily by the first
    HELLO that names them and shared by every later cell.  Runs
    threaded in-process (tests) or as its own process via
    ``python -m repro_torch.launch.cloud``.

    ``device`` is where every session's target model and verify run (the
    card unless the caller asks for the CPU).  ``build_target(cfg, seed,
    device) -> Transformer`` builds a session's target model; the default
    is ``bridge.seeded_model``, the same draw as the edge launcher's.
    This argument is the one API the reference's server lacks: a CPU test
    passes a builder that bridges the reference's ``PRNGKey(seed)``
    parameters (``bridge.from_jax``), so a JAX edge and this server
    verify with the same weights."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 io_timeout_s: float = IO_TIMEOUT_S, device="cuda",
                 build_target: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.build_target = build_target or seeded_model
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self.host, self.port = self._listener.getsockname()[:2]
        self.io_timeout_s = io_timeout_s
        self._sessions: Dict[str, _Session] = {}
        self._sessions_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._accept_thread: Optional[threading.Thread] = None
        self._stopping = False
        # server-side metrics: per-frame-type counters, decode errors,
        # measured verify time.  Always on (the server has no token path
        # to perturb); the edge pulls a snapshot with a STATS frame.
        self.metrics = MetricsRegistry(enabled=True)
        self._metrics_lock = threading.Lock()

    def _count(self, name: str, n: int = 1):
        """Thread-safe counter bump (one connection thread per cell)."""
        with self._metrics_lock:
            self.metrics.counter(name).inc(n)

    def stats_snapshot(self) -> dict:
        with self._metrics_lock:
            return self.metrics.snapshot()

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "CloudServer":
        """Accept connections on a daemon thread (in-process use)."""
        self._accept_thread = threading.Thread(
            target=self.serve_forever, name="cloud-accept", daemon=True)
        self._accept_thread.start()
        return self

    def serve_forever(self):
        """Blocking accept loop (the launch entrypoint's main thread)."""
        while not self._stopping:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                break                       # listener closed: shutting down
            t = threading.Thread(target=self._serve_conn, args=(sock,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stopping = True
        try:
            self._listener.close()
        except OSError:
            pass

    # -- per-connection protocol ----------------------------------------
    def _handshake(self, conn: Conn) -> Optional[_Session]:
        body = conn.recv()
        if body[0] != MSG_HELLO:
            conn.send_json(MSG_ERROR, {"error": "expected HELLO"})
            return None
        hello = tp_mod.decode_json(body[1])
        if hello.get("proto") != PROTO_VERSION:
            conn.send_json(MSG_ERROR, {
                "error": f"protocol version mismatch: server speaks "
                         f"{PROTO_VERSION}, client sent "
                         f"{hello.get('proto')}"})
            return None
        config = hello.get("config")
        codec = (config or {}).get("engine", {}).get("wire_codec")
        if codec not in wire_mod.CODECS:
            conn.send_json(MSG_ERROR, {
                "error": f"unknown wire codec {codec!r}: this server "
                         f"speaks {list(wire_mod.CODECS)}"})
            return None
        sid = str(hello.get("session", ""))
        try:
            with self._sessions_lock:
                if sid not in self._sessions:
                    self._sessions[sid] = _Session(
                        config, self.device, self.build_target)
                sess = self._sessions[sid]
            if sess.config != config:
                conn.send_json(MSG_ERROR, {
                    "error": "session config mismatch: another cell "
                             "created this session with a different "
                             "config digest"})
                return None
        except (TransportError, KeyError, TypeError, ValueError) as e:
            conn.send_json(MSG_ERROR, {"error": f"bad config: {e}"})
            return None
        conn.send_json(MSG_HELLO_OK, {"ok": True})
        return sess

    def _serve_conn(self, sock: socket.socket):
        conn = Conn(sock, timeout_s=self.io_timeout_s)
        try:
            peer = "%s:%d" % sock.getpeername()[:2]
        except OSError:
            peer = "?"
        kind = MSG_HELLO
        try:
            sess = self._handshake(conn)
            if sess is None:
                return
            self._count("cloud.frames.hello")
            while True:
                kind, body = conn.recv()
                self._count(f"cloud.frames.{_msg_name(kind)}")
                if kind == MSG_BYE:
                    return
                if kind == MSG_ADMIT:
                    self._on_admit(sess, tp_mod.decode_json(body))
                elif kind == MSG_VERIFY:
                    self._on_verify(sess, conn, body)
                elif kind == MSG_STATS:
                    conn.send_json(MSG_STATS, self.stats_snapshot())
                else:
                    conn.send_json(MSG_ERROR, {
                        "error": f"unexpected message type {kind}"})
                    return
        except wire_mod.WireDecodeError as e:
            # corrupt payload inside a well-formed frame: count + log
            # (so the failure is observable even if the peer is gone),
            # tell the peer why, then drop the connection — never
            # verify garbage.  The server itself stays up.
            self._count("cloud.wire_decode_errors")
            log.error("wire decode error from %s in %s frame: %s",
                      peer, _msg_name(kind), e)
            try:
                conn.send_json(MSG_ERROR, {"error": f"wire decode: {e}"})
            except OSError:
                pass
        except (TransportError, OSError) as e:
            # peer went away / malformed framing: count, then clean up
            self._count("cloud.transport_errors")
            log.debug("connection from %s dropped in %s frame: %s",
                      peer, _msg_name(kind), e)
        finally:
            conn.close()

    def _on_admit(self, sess: _Session, msg: dict):
        slot = int(msg["slot"])
        # the dtype the in-process engine hands its cloud actor
        # (EdgeEngineBase.admit_slot)
        prompt = torch.as_tensor(msg["prompt"], dtype=torch.int64,
                                 device=sess.cloud.device)
        if not 0 <= slot < sess.n_slots or prompt.shape[0] < 2:
            raise TransportError(f"bad ADMIT: slot={slot} "
                                 f"prompt_len={prompt.shape[0]}")
        with sess.lock:
            sess.cloud.admit(slot, prompt, None, int(msg["seed"]),
                             wire_codec=msg.get("wire_codec"))

    def _on_verify(self, sess: _Session, conn: Conn, body: bytes):
        items = tp_mod.unpack_verify_body(body)
        with sess.lock:
            payloads = {
                slot: sess.fmt.unpack_draft(
                    data, codec=sess.cloud.slot_codec[slot])
                for slot, data in items}
            mask = np.zeros((sess.n_slots,), bool)
            mask[list(payloads)] = True
            vb = sess.cloud.verify(mask, payloads)
            if sess.verdict_batch:
                frame = sess.fmt.pack_verdict_batch(
                    sorted(vb.verdicts.items()), sess.n_slots)
                reply = tp_mod.pack_verdicts_body(vb.t_llm, frame=frame)
            else:
                packed = [(s, sess.fmt.pack_verdict(
                    v, codec=sess.cloud.slot_codec[s]))
                    for s, v in sorted(vb.verdicts.items())]
                reply = tp_mod.pack_verdicts_body(vb.t_llm,
                                                  verdicts=packed)
        with self._metrics_lock:
            self.metrics.counter("cloud.verify_rpcs").inc()
            self.metrics.counter("cloud.verify_slots").inc(len(items))
            self.metrics.histogram("cloud.t_llm_s").observe(vb.t_llm)
        conn.send(MSG_VERDICTS, reply)


# ======================================================================
# Client
# ======================================================================
class EdgeTransportEngine(EdgeEngineBase):
    """The edge half of the engine with its verify peer across a
    socket: admissions are forwarded to the server (``admit_cb``), slot
    allocation on the peer happens once at handshake time (the config
    digest carries n_slots/cache_len), and everything token-affecting
    is inherited unchanged from ``EdgeEngineBase``."""

    admit_cb: Optional[Callable] = None    # EdgeClient wires this up

    def init_slots(self, n_slots: int, cache_len: int,
                   page_size: int = 0, n_pages: Optional[int] = None):
        assert page_size == 0, \
            "tcp transport serves dense slots only (the mirrored page " \
            "allocator would need its own sync protocol)"
        super().init_slots(n_slots, cache_len)

    def _admit_peer(self, slot: int, prompt, pt_row, seed: int,
                    wire_codec: Optional[str]):
        self.admit_cb(slot, prompt.cpu().numpy(), seed, wire_codec)


@dataclasses.dataclass
class NetReport:
    """One tcp run: the streams (for the differential oracle) plus
    MEASURED wall-clock latency — no modeled channel anywhere.  The
    latency dicts are ``obs.metrics.summary_stats`` records (one
    implementation shared with the simulator's report percentiles)."""
    n_total: int
    n_finished: int
    n_rejected: int
    makespan_s: float
    n_verify_rpcs: int
    n_drafts: int
    n_spec_hits: int
    n_spec_misses: int
    rpc_round_s: dict          # client-side VERIFY→VERDICTS round trips
    t_llm_s: dict              # server-measured verify wall-clock
    t_slm_s: dict              # client-measured draft wall-clock
    requests: List[Request]
    # server metrics snapshot pulled with a STATS frame at end of run
    # (None when the pull failed — observability must not fail the run)
    cloud_stats: Optional[dict] = None

    def streams(self) -> Dict[int, Tuple[int, ...]]:
        return {r.rid: tuple(r.tokens) for r in self.requests}

    def summary(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("requests")
        return d


class EdgeClient:
    """Drives ``EdgeDraftEngine`` against a CloudServer over one
    connection per cell, in lockstep or pipelined mode.  ``cfg`` is the
    same ``serve.session.ServeConfig`` the simulator takes (cache_len
    must be resolved; page_size must be 0).  The draft model runs on
    ``device``."""

    def __init__(self, draft_cfg, draft_model, method: MethodConfig,
                 engine: EngineConfig, cfg, arch: str, smoke: bool,
                 host: str, port: int, seed: int = 0,
                 session_id: Optional[str] = None,
                 io_timeout_s: float = IO_TIMEOUT_S,
                 obs: Optional[Obs] = None, device="cuda"):
        assert cfg.page_size == 0, "tcp transport serves dense slots only"
        assert cfg.cache_len > 0, "resolve cache_len before EdgeClient"
        self.cfg = cfg
        # wall-clock spans + client-side counters; pass the SAME Obs the
        # sim oracle used and one trace carries both clocks side by side
        self.obs = obs if obs is not None else NULL_OBS
        self.arch, self.smoke, self.seed = arch, smoke, seed
        self.host, self.port = host, port
        self.io_timeout_s = io_timeout_s
        if is_stateful(draft_cfg):
            raise TransportError(TCP_DRAFT_REFUSAL)
        self.engine = EdgeTransportEngine(
            draft_cfg, draft_model, method, engine,
            channel_mod.ChannelConfig(), seed, device)
        self.engine.admit_cb = self._send_admit
        # per-cell schedulers + slot partition (the links go unused: the
        # wire below is real)
        self.topo = CellTopology(cfg.n_cells, cfg.max_batch,
                                 cfg.queue_cap, cfg.policy,
                                 self.engine.ch)
        self.sched = self.topo
        self.engine.init_slots(cfg.max_batch, cfg.cache_len)
        self.digest = engine_digest(arch, smoke, method, engine, seed,
                                    cfg.max_batch, cfg.cache_len,
                                    cfg.verdict_batch)
        self.session_id = session_id or \
            f"sqs-{seed}-{id(self) & 0xFFFFFF:06x}"
        self._conns: List[Conn] = []

    # -- connection lifecycle -------------------------------------------
    def connect(self) -> "EdgeClient":
        for cell in self.topo.cells:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.io_timeout_s)
            conn = Conn(sock, timeout_s=self.io_timeout_s)
            conn.send_json(MSG_HELLO, {
                "proto": PROTO_VERSION, "session": self.session_id,
                "cell": cell.cell_id, "n_cells": self.cfg.n_cells,
                "config": self.digest})
            tp_mod.decode_json(conn.recv_expect(MSG_HELLO_OK))
            self._conns.append(conn)
        return self

    def close(self):
        for conn in self._conns:
            try:
                conn.send(MSG_BYE)
            except OSError:
                pass
            conn.close()
        self._conns = []

    def __enter__(self):
        return self.connect()

    def __exit__(self, *exc):
        self.close()

    # -- protocol helpers -----------------------------------------------
    def _conn_of_slot(self, slot: int) -> Conn:
        return self._conns[self.topo.cell_of_slot(slot).cell_id]

    def _send_admit(self, slot: int, prompt, seed: int,
                    wire_codec: Optional[str]):
        self._conn_of_slot(slot).send_json(
            MSG_ADMIT, tp_mod.admit_body(slot, seed, wire_codec, prompt))

    def _recv_verdicts(self, conn: Conn):
        body = conn.recv_expect(MSG_VERDICTS)
        t_llm, items, frame = tp_mod.unpack_verdicts_body(body)
        if frame is not None:
            pairs = self.engine.unpack_verdict_batch(frame)
        else:
            pairs = [(s, self.engine.unpack_verdict_slot(s, d))
                     for s, d in items]
        return t_llm, pairs

    # -- trace replay ----------------------------------------------------
    def run_trace(self, trace: List[Request]) -> NetReport:
        assert self._conns, "connect() before run_trace()"
        per_cell = [0] * self.cfg.n_cells
        for req in trace:
            per_cell[req.cell % self.cfg.n_cells] += 1
        assert max(per_cell) <= self.cfg.queue_cap, \
            "tcp replay submits the whole trace up front: each cell's " \
            "arrival count must fit its waiting room (raise queue_cap)"
        start = time.perf_counter()
        clock = lambda: time.perf_counter() - start  # noqa: E731
        rsm = RoundStateMachine(
            self.engine, self.sched,
            self.cfg.speculate and self.cfg.pipeline == "pipelined",
            self.cfg.cache_len, obs=self.obs, clock=CLOCK_WALL)
        self._rpc_s: List[float] = []
        self._t_llm: List[float] = []
        self._t_slm: List[float] = []
        self._n_rpcs = 0
        for req in sorted(trace, key=lambda r: r.t_arrival):
            rsm.submit(req, clock())    # oversized rejects mirror the sim
        if self.cfg.pipeline == "pipelined":
            self._run_pipelined(rsm, clock)
        else:
            self._run_lockstep(rsm, clock)
        assert self.sched.n_active == 0 and not self.sched.waiting
        requests = sorted(self.sched.finished + self.sched.rejected,
                          key=lambda r: r.rid)
        cloud_stats = None
        if self.obs.enabled:
            try:
                cloud_stats = self.fetch_cloud_stats()
            except (TransportError, OSError) as e:
                log.warning("STATS pull failed: %s", e)
        return NetReport(
            n_total=len(trace), n_finished=len(self.sched.finished),
            n_rejected=len(self.sched.rejected), makespan_s=clock(),
            n_verify_rpcs=self._n_rpcs, n_drafts=rsm.n_drafts,
            n_spec_hits=rsm.n_spec_hits,
            n_spec_misses=rsm.n_spec_misses,
            rpc_round_s=summary_stats(self._rpc_s),
            t_llm_s=summary_stats(self._t_llm),
            t_slm_s=summary_stats(self._t_slm),
            requests=requests, cloud_stats=cloud_stats)

    def fetch_cloud_stats(self) -> dict:
        """Pull the server's metrics snapshot over the first cell's
        connection (STATS request/response) — observability only; the
        reply never feeds the token path."""
        assert self._conns, "connect() before fetch_cloud_stats()"
        conn = self._conns[0]
        conn.send_json(MSG_STATS, {})
        return tp_mod.decode_json(conn.recv_expect(MSG_STATS))

    # -- lockstep: one barrier round per iteration ----------------------
    def _run_lockstep(self, rsm: RoundStateMachine, clock):
        tr = self.obs.tracer
        while self.sched.has_work():
            rsm.admit_ready(clock())
            slots = sorted(rsm.slots)
            assert slots, "has_work() but nothing admitted"
            t_draft = clock()
            recs = rsm.draft_many(slots)
            self._t_slm.append(recs[slots[0]].t_slm)  # one batched draft
            tr.span("draft", t_draft, clock(), clock=CLOCK_WALL,
                    tid="edge", args={"n_slots": len(slots)})
            t_send = clock()
            groups = self.topo.slot_groups(slots)
            for cell, cslots in groups:
                self._conns[cell.cell_id].send(
                    MSG_VERIFY, tp_mod.pack_verify_body(
                        [(s, recs[s].packed) for s in cslots]))
                self._n_rpcs += 1
            verdicts = {}
            for cell, _ in groups:
                t_llm, pairs = self._recv_verdicts(
                    self._conns[cell.cell_id])
                self._t_llm.append(t_llm)
                verdicts.update(dict(pairs))
            rpc = clock() - t_send
            self._rpc_s.append(rpc)
            tr.span("verify_rpc", t_send, t_send + rpc, clock=CLOCK_WALL,
                    tid="edge", args={"n_slots": len(slots)})
            self.obs.metrics.histogram("edge.rpc_round_s").observe(rpc)
            for slot in slots:           # ascending slot order, like sim
                rsm.apply_verdict(slot, verdicts[slot], clock())

    # -- pipelined: per-slot rounds, verdicts applied as they arrive ----
    def _run_pipelined(self, rsm: RoundStateMachine, clock):
        sel = selectors.DefaultSelector()
        for cell_id, conn in enumerate(self._conns):
            sel.register(conn.sock, selectors.EVENT_READ, cell_id)
        sent_at: Dict[int, float] = {}
        tr = self.obs.tracer

        def send_round(slot, rec):
            self._conn_of_slot(slot).send(
                MSG_VERIFY, tp_mod.pack_verify_body([(slot, rec.packed)]))
            self._n_rpcs += 1
            sent_at[slot] = clock()
            # the edge device is idle until the verdict returns
            rsm.speculate_after(slot, rec)

        def start_round(slot):
            t0 = clock()
            rec = rsm.draft(slot)
            self._t_slm.append(rec.t_slm)
            tr.span("draft", t0, clock(), clock=CLOCK_WALL,
                    tid=f"slot{slot}")
            send_round(slot, rec)

        try:
            for slot in rsm.admit_ready(clock()):
                start_round(slot)
            while self.sched.has_work():
                ready = sel.select(timeout=self.io_timeout_s)
                if not ready:
                    raise TransportError(
                        "timed out waiting for verdicts")
                for key, _ in ready:
                    conn = self._conns[key.data]
                    t_llm, pairs = self._recv_verdicts(conn)
                    self._t_llm.append(t_llm)
                    for slot, verdict in pairs:
                        t_sent = sent_at.pop(slot)
                        now = clock()
                        self._rpc_s.append(now - t_sent)
                        tr.span("verify_rpc", t_sent, now,
                                clock=CLOCK_WALL, tid=f"slot{slot}")
                        self.obs.metrics.histogram(
                            "edge.rpc_round_s").observe(now - t_sent)
                        out = rsm.apply_verdict(slot, verdict, clock())
                        if out.finished:
                            for s in rsm.admit_ready(clock()):
                                start_round(s)
                        elif out.spec_round is not None:
                            # confirmed speculation: its payload is
                            # ready now — send, then draft ahead again
                            self._t_slm.append(out.spec_round.t_slm)
                            send_round(slot, out.spec_round)
                        else:
                            start_round(slot)
        finally:
            sel.close()


# ======================================================================
# Process helpers (launch, chip_smoke.py)
# ======================================================================
def wait_port_file(path: str, timeout_s: float = 180.0) -> int:
    """Poll for the port file ``launch.cloud --port-file`` writes."""
    import os
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                text = f.read().strip()
            if text:
                return int(text)
        time.sleep(0.05)
    raise TimeoutError(f"no cloud port file at {path} "
                       f"after {timeout_s:.0f}s")
