"""Disaggregated edge–cloud SQS speculative decoding engine (the paper's
Algorithm 1), mirroring ``repro.core.engine`` for the fixed-batch path.

Two actors talk only through ``core.wire`` bytes:

  ``EdgeDraftEngine``   — SLM decode loop, SQS sparsify/quantize (the fused
      Hopper kernels on a CUDA device when ``MethodConfig.use_kernels``),
      conformal β state, bit-budget truncation L^t, payload packing and
      verdict application;
  ``CloudVerifyEngine`` — payload unpacking, LLM parallel verify, the
      Algorithm-1 β backtrack from the wire trajectory, verdict packing.

``EdgeCloudEngine`` moves the packed payloads between them in lockstep
(``prefill`` / ``run_round`` / ``run``).  Both actors keep the reference's
replay registers — the inputs of every row's last committed step — and
feed them to rows outside a call's commit mask, so those rows re-execute
their previous step bit for bit; the serving slice (slot API, paged KV,
event loop) builds on that.

Randomness comes only from per-row threefry keys (``repro_torch.prng``),
which give jax's bits: the token streams equal the reference's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import bits as bits_mod
from repro_torch.core import channel as channel_mod
from repro_torch.core import conformal
from repro_torch.core import sqs as sqs_mod
from repro_torch.core import verify as verify_mod
from repro_torch.core import wire as wire_mod
from repro_torch.models import model as model_mod

SEQ_BLOCKS = ("mamba", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    name: str = "csqs"               # ksqs | csqs | qs | uncompressed
    K: int = 64                      # K-SQS cardinality
    ell: int = 100                   # lattice resolution ℓ
    alpha: float = 5e-4              # C-SQS target deviation
    eta: float = 1e-3                # C-SQS learning rate
    beta0: float = 1e-3              # C-SQS initial threshold
    use_kernels: bool = True         # fused SQS path (repro_torch.kernels)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    L_max: int = 8                   # max drafts per batch
    bit_budget: float = 5000.0       # uplink budget B per batch (bits)
    temperature: float = 1.0
    collect_theory: bool = False     # keep dense q/p for Theorem-1 logging
    wire_codec: str = "v1"           # core.wire.CODECS
    budget_model: str = "analytic"   # analytic | calibrated


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def row_key(seed: int, row: int = 0, device="cpu"):
    """Per-row PRNG root: fold the row index into the stream seed."""
    return prng.fold_in(prng.PRNGKey(seed, device), row)


def cloud_row_key(seed: int, row: int = 0, device="cpu"):
    """The cloud actor's independent per-row PRNG root."""
    return prng.fold_in(row_key(seed, row, device), 0x0C10)


def _split_rows(keys, num: int = 2):
    """keys: (B, 2) -> num independent per-row subkeys, each (B, 2)."""
    kk = prng.split(keys, num)
    return tuple(kk[:, i] for i in range(num))


def _check_dense(cfg: ModelConfig):
    if any(b in SEQ_BLOCKS for b in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: sequential-state (SSM) models are not ported yet")


@dataclasses.dataclass
class DraftBatch:
    """Full-batch draft results (lockstep path + payload source)."""
    ys: dict                      # device trajectories, (L+1, B, ...)
    drafts: np.ndarray            # (L+1, B)
    betas: np.ndarray             # (L+1, B)
    bits: np.ndarray              # (B, L) analytic per-token budget
    gap_bits: np.ndarray          # (B, L)
    dropped: np.ndarray           # (B, L+1)
    Ks: np.ndarray                # (B, L)
    live: np.ndarray              # (B, L) bool
    n_live: np.ndarray            # (B,) int
    packed: Dict[int, bytes]      # per committed slot
    t_slm: float
    scale_next: Dict[int, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class VerifyBatch:
    """Cloud-side verify results for one call."""
    verdicts: Dict[int, wire_mod.VerdictPayload]
    T: np.ndarray                 # (B,) accepted counts
    new_token: np.ndarray         # (B,)
    rejected: np.ndarray          # (B,) bool
    p: Optional[np.ndarray]       # (B, L+1, V) when collect_theory
    t_llm: float


# ======================================================================
# Edge actor
# ======================================================================
class EdgeDraftEngine:
    """SLM drafting + SQS compression + conformal state + packing."""

    def __init__(self, dc: ModelConfig, model, method: MethodConfig,
                 engine: EngineConfig, fmt: wire_mod.WireFormat,
                 seed: int = 0, device="cuda"):
        _check_dense(dc)
        self.dc, self.model = dc, model
        self.m, self.e, self.fmt = method, engine, fmt
        self.seed = seed
        self.V = dc.vocab
        self.device = resolve_device(device)

    # -- SQS -----------------------------------------------------------
    def _sparsify(self, logits, beta):
        m, V = self.m, self.V
        if m.use_kernels and m.name in ("ksqs", "csqs"):
            # the kernels compute their own softmax
            from repro_torch.kernels import ops as kops
            if m.name == "ksqs":
                r = kops.sqs_topk(logits, m.K, temperature=self.e.temperature,
                                  ell=m.ell)
            else:
                r = kops.sqs_threshold(logits, beta,
                                       temperature=self.e.temperature,
                                       ell=m.ell)
            return self._sqs_bits(r)
        q = sqs_mod.softmax_temp(logits, self.e.temperature)
        if m.name == "ksqs":
            r = sqs_mod.sparsify_topk(q, m.K, m.ell)
        elif m.name == "csqs":
            r = sqs_mod.sparsify_threshold(q, beta, m.ell)
        elif m.name == "qs":
            r = sqs_mod.dense_qs(q, m.ell)
        elif m.name == "uncompressed":
            r = sqs_mod.no_compression(q)
        else:
            raise ValueError(m.name)
        return self._sqs_bits(r)

    def _sqs_bits(self, r):
        m, V = self.m, self.V
        if m.name == "ksqs":
            bits = torch.full_like(r.dropped, bits_mod.token_bits(
                V, float(m.K), m.ell, adaptive=False))
        elif m.name == "csqs":
            bits = bits_mod.token_bits(V, r.K.float(), m.ell, adaptive=True)
        elif m.name == "qs":
            bits = torch.full_like(r.dropped,
                                   bits_mod.dense_qs_bits(V, m.ell))
        else:
            bits = torch.full_like(r.dropped, bits_mod.uncompressed_bits(V))
        gap_bits = (bits_mod.gap_code_subset_bits(r.mask)
                    + bits_mod.payload_bits(r.K.float(), m.ell)
                    + (float(np.ceil(np.log2(float(V))))
                       if m.name == "csqs" else 0.0))
        return r, bits, gap_bits

    def _draft_round(self, x_last, pos, beta, keys):
        """L_max+1 decode steps.  Returns per-step trajectories stacked to
        (L+1, B, ...): drafts, q̂, bits, dropped mass, K and the β after
        each in-round update.  keys: (B, 2) per-row PRNG keys."""
        steps = []
        tok = x_last
        for _ in range(self.e.L_max + 1):
            keys, k1 = _split_rows(keys)
            logits, self.dcache = model_mod.decode_step(self.model, tok,
                                                        self.dcache, pos)
            r, bits, gap_bits = self._sparsify(logits, beta)
            nxt = prng.categorical(
                k1, torch.log(torch.clamp(r.q_hat, min=1e-30)))
            if self.m.name == "csqs":
                beta = conformal.update(beta, r.dropped, self.m.alpha,
                                        self.m.eta)
            step = dict(token=nxt, q_hat=r.q_hat, bits=bits,
                        gap_bits=gap_bits, dropped=r.dropped, K=r.K,
                        beta=beta)
            if self.e.collect_theory:
                step["q"] = sqs_mod.softmax_temp(logits, self.e.temperature)
            steps.append(step)
            tok, pos = nxt, pos + 1
        return {name: torch.stack([s[name] for s in steps])
                for name in steps[0]}

    # -- state ---------------------------------------------------------
    def _alloc_state(self, B: int):
        dev = self.device
        self.B = B
        self.x_last = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.beta = torch.full((B,), self.m.beta0, dtype=torch.float32,
                               device=dev)
        self.keys = torch.stack([row_key(self.seed, b, dev)
                                 for b in range(B)])
        # replay registers: inputs of each row's last committed draft
        self.rep_x, self.rep_pos = self.x_last, self.pos
        self.rep_beta, self.rep_key = self.beta, self.keys
        self.slot_codec = [self.fmt.codec] * B
        self.coded_scale = np.ones((B,), np.float64)

    def prefill_batch(self, prompts, cache_len: int):
        B, S0 = prompts.shape
        self._alloc_state(B)
        self.cache_len = cache_len
        _, self.dcache = model_mod.prefill(self.model, prompts[:, :-1],
                                           cache_len=cache_len)
        self.x_last = prompts[:, -1].clone()
        self.pos = torch.full((B,), S0 - 1, dtype=torch.int64,
                              device=self.device)
        self.rep_x, self.rep_pos = self.x_last, self.pos

    # -- drafting ------------------------------------------------------
    def _run_draft(self, x_in, pos_in, beta_in, key_in):
        new_keys, kd = _split_rows(key_in)
        _sync(self.device)
        t0 = time.perf_counter()
        ys = self._draft_round(x_in, pos_in, beta_in, kd)
        _sync(self.device)
        return ys, new_keys, time.perf_counter() - t0

    def _live_counts(self, bits: np.ndarray, mask: np.ndarray):
        """Budget-driven L^t (paper §4): stop when estimated wire bits
        exceed the budget, ≥ 1; non-committed rows transmit nothing."""
        est = bits
        if self.e.budget_model == "calibrated":
            est = bits * self.coded_scale[:, None]
        live = np.cumsum(est, axis=1) <= self.e.bit_budget
        live[:, 0] = True
        live &= mask[:, None]
        return live, live.sum(1)

    _SCALE_DECAY = 0.7
    _SCALE_CLIP = (0.25, 8.0)

    def _scale_update(self, slot: int, obs_bits: float,
                      est_bits: float) -> float:
        ratio = obs_bits / max(est_bits, 1.0)
        lo, hi = self._SCALE_CLIP
        return float(np.clip(self._SCALE_DECAY * self.coded_scale[slot]
                             + (1.0 - self._SCALE_DECAY) * ratio, lo, hi))

    def commit_scales(self, scale_next: Dict[int, float]):
        for slot, s in scale_next.items():
            self.coded_scale[slot] = s

    def _build_batch(self, ys, mask: np.ndarray, t_slm: float) -> DraftBatch:
        L = self.e.L_max

        def host(name, n=None):
            return ys[name][:n].cpu().numpy()
        drafts = host("token")                            # (L+1, B)
        betas = host("beta")                              # (L+1, B)
        bits = host("bits", L).T                          # (B, L)
        gap_bits = host("gap_bits", L).T
        dropped = host("dropped").T                       # (B, L+1)
        Ks = host("K", L).T
        live, n_live = self._live_counts(bits, mask)
        packed, scale_next = {}, {}
        for slot in np.nonzero(mask)[0]:
            slot = int(slot)
            qhat_row = ys["q_hat"][:L, slot].cpu().numpy()
            payload = wire_mod.build_draft_payload(
                self.fmt, drafts[:, slot], qhat_row, betas[:, slot],
                int(n_live[slot]))
            data = self.fmt.pack_draft(payload, codec=self.slot_codec[slot])
            packed[slot] = data
            if self.e.budget_model == "calibrated":
                est = float(bits[slot, :int(n_live[slot])].sum())
                scale_next[slot] = self._scale_update(slot, len(data) * 8.0,
                                                      est)
        return DraftBatch(ys=ys, drafts=drafts, betas=betas, bits=bits,
                          gap_bits=gap_bits, dropped=dropped, Ks=Ks,
                          live=live, n_live=n_live, packed=packed,
                          t_slm=t_slm, scale_next=scale_next)

    def draft(self, mask: np.ndarray) -> DraftBatch:
        """One draft round, committing key-chain/replay state for rows in
        ``mask``; other rows replay their registers."""
        mj = torch.as_tensor(mask, device=self.device)
        x_in = torch.where(mj, self.x_last, self.rep_x)
        pos_in = torch.where(mj, self.pos, self.rep_pos)
        beta_in = torch.where(mj, self.beta, self.rep_beta)
        key_in = torch.where(mj[:, None], self.keys, self.rep_key)
        ys, new_keys, t_slm = self._run_draft(x_in, pos_in, beta_in, key_in)
        self.keys = torch.where(mj[:, None], new_keys, self.keys)
        self.rep_x, self.rep_pos, self.rep_beta = x_in, pos_in, beta_in
        self.rep_key = torch.where(mj[:, None], key_in, self.rep_key)
        batch = self._build_batch(ys, mask, t_slm)
        self.commit_scales(batch.scale_next)
        return batch

    # -- verdict application -------------------------------------------
    def apply_verdicts_batch(self, mask: np.ndarray,
                             verdicts: Dict[int, wire_mod.VerdictPayload],
                             batch: DraftBatch) -> List[List[int]]:
        """Whole-batch verdict application: β resume from the wire,
        position/x_last advance, token emission.  (Positional KV caches
        need no rollback.)"""
        B = self.B
        T_np = np.zeros((B,), np.int64)
        nt_np = np.zeros((B,), np.int64)
        beta_np = self.beta.cpu().numpy().copy()
        for slot, v in verdicts.items():
            T_np[slot] = v.n_accept
            nt_np[slot] = v.new_token
            beta_np[slot] = np.float32(v.beta_next)
        dev = self.device
        mj = torch.as_tensor(mask, device=dev)
        if self.m.name == "csqs":
            self.beta = torch.where(mj, torch.from_numpy(beta_np).to(dev),
                                    self.beta)
        self.pos = self.pos + torch.where(
            mj, torch.from_numpy(T_np).to(dev) + 1, 0)
        self.x_last = torch.where(mj, torch.from_numpy(nt_np).to(dev),
                                  self.x_last)
        emitted = [[] for _ in range(B)]
        for slot in verdicts:
            emitted[slot] = ([int(t) for t in batch.drafts[:T_np[slot], slot]]
                             + [int(nt_np[slot])])
        return emitted


# ======================================================================
# Cloud actor
# ======================================================================
class CloudVerifyEngine:
    """LLM parallel verification against the transmitted q̂."""

    def __init__(self, tc: ModelConfig, model, method: MethodConfig,
                 engine: EngineConfig, fmt: wire_mod.WireFormat,
                 seed: int = 0, device="cuda"):
        _check_dense(tc)
        self.tc, self.model = tc, model
        self.m, self.e, self.fmt = method, engine, fmt
        self.seed = seed
        self.V = tc.vocab
        self.device = resolve_device(device)

    def _verify_round(self, tokens_in, pos, q_hat, live, keys):
        """tokens_in: (B, L+1) = [x_last, d_1..d_L]."""
        logits, self.tcache = model_mod.extend_step(self.model, tokens_in,
                                                    self.tcache, pos)
        p = sqs_mod.softmax_temp(logits, self.e.temperature)  # (B, L+1, V)
        return verify_mod.verify(keys, tokens_in[:, 1:], q_hat, p, live), p

    def _alloc_state(self, B: int):
        L, dev = self.e.L_max, self.device
        self.B = B
        self.x_last = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.keys = torch.stack([cloud_row_key(self.seed, b, dev)
                                 for b in range(B)])
        # replay registers: inputs of each row's last committed verify
        self.rep_tokens = torch.zeros((B, L), dtype=torch.int64, device=dev)
        self.rep_qhat = torch.zeros((B, L, self.V), dtype=torch.float32,
                                    device=dev)
        self.rep_live = torch.zeros((B, L), dtype=torch.bool, device=dev)
        self.rep_x, self.rep_pos, self.rep_key = \
            self.x_last, self.pos, self.keys
        self.slot_codec = [self.fmt.codec] * B

    def prefill_batch(self, prompts, cache_len: int):
        B, S0 = prompts.shape
        self._alloc_state(B)
        self.cache_len = cache_len
        _, self.tcache = model_mod.prefill(self.model, prompts[:, :-1],
                                           cache_len=cache_len)
        self.x_last = prompts[:, -1].clone()
        self.pos = torch.full((B,), S0 - 1, dtype=torch.int64,
                              device=self.device)
        self.rep_x, self.rep_pos = self.x_last, self.pos

    def verify(self, mask: np.ndarray,
               payloads: Dict[int, wire_mod.DraftPayload],
               collect_p: bool = False) -> VerifyBatch:
        """Verify the rows in ``mask`` against their unpacked payloads;
        other rows replay their registers.  Packs one verdict per payload,
        including the Alg.-1 β backtrack from the wire trajectory."""
        B, L, dev = self.B, self.e.L_max, self.device
        tok_np = np.zeros((B, L), np.int64)
        qhat_np = np.zeros((B, L, self.V), np.float32)
        live_np = np.zeros((B, L), bool)
        for slot, p in payloads.items():
            assert mask[slot], f"payload for non-committed slot {slot}"
            tok_np[slot], qhat_np[slot], live_np[slot] = \
                wire_mod.draft_arrays(self.fmt, p)
        mj = torch.as_tensor(mask, device=dev)
        tokens = torch.where(mj[:, None], torch.from_numpy(tok_np).to(dev),
                             self.rep_tokens)
        qhat = torch.where(mj[:, None, None],
                           torch.from_numpy(qhat_np).to(dev), self.rep_qhat)
        live = torch.where(mj[:, None], torch.from_numpy(live_np).to(dev),
                           self.rep_live)
        x_in = torch.where(mj, self.x_last, self.rep_x)
        pos_in = torch.where(mj, self.pos, self.rep_pos)
        key_in = torch.where(mj[:, None], self.keys, self.rep_key)
        new_keys, kv = _split_rows(key_in)
        tokens_in = torch.cat([x_in[:, None], tokens], 1)
        _sync(dev)
        t0 = time.perf_counter()
        res, p_dists = self._verify_round(tokens_in, pos_in, qhat, live, kv)
        _sync(dev)
        t_llm = time.perf_counter() - t0
        T = res.n_accept.to(torch.int64)
        self.pos = torch.where(mj, pos_in + T + 1, self.pos)
        self.x_last = torch.where(mj, res.new_token.to(torch.int64),
                                  self.x_last)
        self.keys = torch.where(mj[:, None], new_keys, self.keys)
        self.rep_tokens, self.rep_qhat, self.rep_live = tokens, qhat, live
        self.rep_x, self.rep_pos = x_in, pos_in
        self.rep_key = torch.where(mj[:, None], key_in, self.rep_key)
        T_np = T.cpu().numpy()
        nt_np = res.new_token.cpu().numpy()
        verdicts = {
            slot: wire_mod.VerdictPayload(
                n_accept=int(T_np[slot]), new_token=int(nt_np[slot]),
                beta_next=conformal.backtrack_wire(p.betas,
                                                   int(T_np[slot])))
            for slot, p in payloads.items()}
        return VerifyBatch(verdicts=verdicts, T=T_np, new_token=nt_np,
                           rejected=res.rejected.cpu().numpy(),
                           p=p_dists.cpu().numpy() if collect_p else None,
                           t_llm=t_llm)


# ======================================================================
# Facade: lockstep rounds over the wire
# ======================================================================
class EdgeCloudEngine:
    """Owns the two actors and moves packed payloads between them.
    ``run_round`` is the lockstep schedule of Algorithm 1.  The slot
    API (admit/release per request), speculative drafting and the paged
    KV pool come with the serving slice."""

    def __init__(self, draft_cfg: ModelConfig, draft_model,
                 target_cfg: ModelConfig, target_model,
                 method: MethodConfig, engine: EngineConfig = EngineConfig(),
                 channel: channel_mod.ChannelConfig =
                 channel_mod.ChannelConfig(),
                 seed: int = 0, device="cuda"):
        assert draft_cfg.vocab == target_cfg.vocab, "shared vocabulary"
        assert engine.wire_codec in wire_mod.CODECS, engine.wire_codec
        assert engine.budget_model in ("analytic", "calibrated"), \
            engine.budget_model
        self.device = resolve_device(device)
        self.dc, self.tc = draft_cfg, target_cfg
        self.m, self.e, self.ch = method, engine, channel
        self.seed = seed
        self.V = draft_cfg.vocab
        self.fmt = wire_mod.WireFormat(
            V=self.V, ell=method.ell, L_max=engine.L_max,
            mode="raw" if method.name == "uncompressed" else "lattice",
            codec=engine.wire_codec)
        self.edge = EdgeDraftEngine(draft_cfg, draft_model, method, engine,
                                    self.fmt, seed, self.device)
        self.cloud = CloudVerifyEngine(target_cfg, target_model, method,
                                       engine, self.fmt, seed, self.device)

    @property
    def beta(self):
        return self.edge.beta

    @property
    def pos(self):
        return self.edge.pos

    def prefill(self, prompts):
        """prompts: (B, S0) ints.  Prepares both actors; the last prompt
        token becomes x_last (first token the draft loop processes)."""
        prompts = torch.as_tensor(np.array(prompts), dtype=torch.int64,
                                  device=self.device)
        B, S0 = prompts.shape
        self.B = B
        total = S0 + 4096  # cache capacity headroom
        self.edge.prefill_batch(prompts, total)
        self.cloud.prefill_batch(prompts, total)
        self.active = np.ones((B,), bool)
        self.out_tokens = [[] for _ in range(B)]

    # -- per-slot verdict codec and verdict batching ---------------------
    def pack_verdict_slot(self, slot: int,
                          v: wire_mod.VerdictPayload) -> bytes:
        return self.fmt.pack_verdict(v, codec=self.cloud.slot_codec[slot])

    def unpack_verdict_slot(self, slot: int,
                            data: bytes) -> wire_mod.VerdictPayload:
        return self.fmt.unpack_verdict(data,
                                       codec=self.edge.slot_codec[slot])

    def pack_verdict_batch(self, verdicts: Dict[int,
                                                wire_mod.VerdictPayload]
                           ) -> bytes:
        """One cell's verdicts in ascending slot order, one frame."""
        return self.fmt.pack_verdict_batch(sorted(verdicts.items()), self.B)

    def unpack_verdict_batch(self, data: bytes):
        return self.fmt.unpack_verdict_batch(data, self.B)

    # ------------------------------------------------------------------
    def run_round(self, verdict_groups: Optional[List[List[int]]] = None):
        """One lockstep SD batch over the active rows, through the wire.
        Returns a metrics dict (host values).  ``verdict_groups``: lists of
        slots sharing a downlink; each group's verdicts cross as ONE coded
        frame, and the edge applies the frame-decoded verdicts."""
        L = self.e.L_max
        active = np.asarray(self.active, bool)
        n_active = max(int(active.sum()), 1)

        db = self.edge.draft(active)
        # --- the uplink: packed bytes cross, the cloud decodes ---------
        payloads = wire_mod.unpack_drafts(
            self.fmt, db.packed,
            codecs={s: self.cloud.slot_codec[s] for s in db.packed})
        wire_bits_row = np.zeros((self.B,), np.float64)
        for slot, data in db.packed.items():
            wire_bits_row[slot] = wire_mod.packed_bits(data)
        vb = self.cloud.verify(active, payloads,
                               collect_p=self.e.collect_theory)
        # --- the downlink: packed verdicts cross back ------------------
        verdict_packed = {s: self.pack_verdict_slot(s, v)
                          for s, v in vb.verdicts.items()}
        verdict_bits_row = np.zeros((self.B,), np.float64)
        for slot, data in verdict_packed.items():
            verdict_bits_row[slot] = wire_mod.packed_bits(data)
        verdict_frames = []
        if verdict_groups is None:
            verdicts = {s: self.unpack_verdict_slot(s, b)
                        for s, b in verdict_packed.items()}
        else:
            verdicts = {}
            grouped = [s for g in verdict_groups for s in g]
            assert sorted(grouped) == sorted(vb.verdicts), \
                "verdict_groups must cover exactly the active slots"
            for group in verdict_groups:
                items = {s: vb.verdicts[s] for s in group}
                if not items:
                    continue
                frame = self.pack_verdict_batch(items)
                verdicts.update(dict(self.unpack_verdict_batch(frame)))
                verdict_frames.append(
                    {"slots": sorted(items),
                     "bits": wire_mod.packed_bits(frame)})
        emitted = self.edge.apply_verdicts_batch(active, verdicts, db)
        for b in range(self.B):
            self.out_tokens[b].extend(emitted[b])

        T_np = vb.T
        live_np = db.live
        bits_row = (db.bits * live_np).sum(1)
        gap_bits_row = (db.gap_bits * live_np).sum(1)
        wire_bits = float(wire_bits_row.sum() / n_active)
        t_up = channel_mod.uplink_time(self.ch, wire_bits)
        t_down = channel_mod.downlink_time(
            self.ch, float(verdict_bits_row.max()) if active.any()
            else channel_mod.feedback_bits(L, self.V))
        metrics = {
            "n_accept": np.where(active, T_np, 0),
            "rejected": vb.rejected & active,
            "L_live": live_np.sum(1),
            "bits": float(bits_row.sum() / n_active),
            "gap_bits": float(gap_bits_row.sum() / n_active),
            "bits_row": bits_row,
            "gap_bits_row": gap_bits_row,
            "wire_bits": wire_bits,
            "wire_bits_row": wire_bits_row,
            "verdict_bits_row": verdict_bits_row,
            "verdict_frames": verdict_frames,
            "active": active.copy(),
            "emitted": emitted,
            "K_mean": float((db.Ks * live_np).sum()
                            / max(live_np.sum(), 1)),
            "dropped_mean": float(db.dropped[active, :L].mean())
            if active.any() else 0.0,
            "t_slm": db.t_slm, "t_up": t_up, "t_llm": vb.t_llm,
            "t_down": t_down,
            "t_total": db.t_slm + t_up + vb.t_llm + t_down,
            "tokens_out": np.where(active, 1 + T_np, 0),
            "beta_row": db.betas[0].copy(),
            "packed": dict(db.packed),
            "verdict_packed": verdict_packed,
        }
        if self.e.collect_theory:
            metrics["q"] = db.ys["q"][:L].transpose(0, 1).cpu().numpy()
            metrics["q_hat"] = db.ys["q_hat"][:L].transpose(0, 1) \
                .cpu().numpy()
            metrics["p"] = vb.p
            metrics["dropped_seq"] = db.dropped
            metrics["K_seq"] = db.Ks
            metrics["live_seq"] = live_np.copy()
        return metrics

    def run(self, prompts, n_rounds: int):
        self.prefill(prompts)
        rounds = [self.run_round() for _ in range(n_rounds)]
        return rounds, self.out_tokens


def summarize(rounds):
    """Aggregate per-round metrics into the paper's two headline numbers:
    average end-to-end latency per batch and resampling rate."""
    resample = np.mean([r["rejected"].mean() for r in rounds])
    lat = np.mean([r["t_total"] for r in rounds])
    toks = np.sum([r["tokens_out"].mean() for r in rounds])
    return {
        "resampling_rate": float(resample),
        "latency_per_batch_s": float(lat),
        "latency_per_token_s": float(lat * len(rounds) / max(toks, 1)),
        "bits_per_batch": float(np.mean([r["bits"] for r in rounds])),
        "gap_bits_per_batch": float(np.mean([r["gap_bits"]
                                             for r in rounds])),
        "wire_bits_per_batch": float(np.mean([r.get("wire_bits", 0.0)
                                              for r in rounds])),
        "accept_rate": float(np.mean(
            [r["n_accept"].mean() / max(r["L_live"].mean(), 1)
             for r in rounds])),
        "mean_K": float(np.mean([r["K_mean"] for r in rounds])),
        "tokens_per_batch": float(np.mean([r["tokens_out"].mean()
                                           for r in rounds])),
    }
