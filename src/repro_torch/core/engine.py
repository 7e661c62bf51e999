"""Disaggregated edge–cloud SQS speculative decoding engine (the paper's
Algorithm 1), mirroring ``repro.core.engine``.

Two actors talk only through ``core.wire`` bytes:

  ``EdgeDraftEngine``   — SLM decode loop, SQS sparsify/quantize (the fused
      Hopper kernels on a CUDA device when ``MethodConfig.use_kernels``),
      conformal β state, bit-budget truncation L^t, payload packing and
      verdict application;
  ``CloudVerifyEngine`` — payload unpacking, LLM parallel verify, the
      Algorithm-1 β backtrack from the wire trajectory, verdict packing.

``EdgeEngineBase`` holds every token-affecting EDGE step the serving
loops need: the slot lifecycle (``init_slots`` / ``admit_slot`` /
``release_slot``, with the paged pool's allocator mirrored on both
sides), per-slot drafting, speculative continuation and verdict
application.  ``EdgeCloudEngine`` adds the in-process cloud actor
through three hooks (``_init_peer_slots``, ``_admit_peer``,
``_push_tables``), the per-slot ``verify_slots`` and the lockstep
``prefill`` / ``run_round`` / ``run``.

Both actors keep replay registers — the inputs of the last round that
wrote each row's cache — and feed them to rows outside a call's commit
mask, so those rows re-execute that round bit for bit: a request's
stream does not depend on which requests share the batch or on how
calls interleave in time.  A speculative draft (``draft_speculative``)
moves its slot's registers to its own inputs at once, while the key
chain and the calibrated scale advance only when the verdict confirms
it (``commit_speculative``): a later call that drafts another slot then
rewrites the speculative round's KV with the same values.  The
reference keeps the registers at the last committed round until the
confirmation, so there such a call overwrites the speculative round's
KV past pos + n_live + 1 with the committed round's drafts, and the
round after a confirmed speculative round reads keys of tokens that are
not in the stream (ROADMAP Queue 3 item 14).  State tensors are
replaced, never written in place (registers alias them); only the KV
caches are written in place.

Models with sequential state (Mamba, mLSTM, sLSTM layers) cannot mask a
rejected draft away the way a KV entry is masked: the draft keeps a
snapshot of every stateful layer's state after each of its L+1 steps,
the verify collects the state after each of its L+1 positions, and both
caches roll back to the snapshot after the last kept token
(``rollback_cache``).  As in the reference, a row outside the commit
mask replays its registers through its state too and is rolled back to
the snapshot after one replayed token; such a row is an empty slot,
which the next admission overwrites.  Stateful models serve lockstep
only: the optimistic continuation and per-slot verdicts of pipelined
serving need positional caches.

A sliding-window model's attention cache is a ring.  The reference's
ring of W slots cannot take back a rejected draft once it has wrapped
(the draft's write overwrote a key still inside the window;
``models.attention``); both actors here build their rings ``ring_spare``
slots longer, so what a rejected or speculative draft writes past the
committed position never stands for a key a later query reads, and a
sliding-window pair serves past its window.

An encoder-decoder model is not served: the reference's fixed-batch
prefill calls the model without the encoder's frames and crashes, and its
slot mode asserts against it.  Both actors refuse one by name
(``EncoderDecoderServingError``) in the same places; the model API
(``models.model``) and training run it.

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
from repro_torch.core.pages import PageAllocator
from repro_torch.models import model as model_mod
from repro_torch.models.attention import PagedSpec, sanitize_page_table
from repro_torch.models.transformer import SEQ_BLOCKS


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


def row_key(seed: int, row: int = 0, device="cuda"):
    """Per-row PRNG root: fold the row index into the stream seed."""
    return prng.fold_in(prng.PRNGKey(seed, device), row)


def cloud_row_key(seed: int, row: int = 0, device="cuda"):
    """The cloud actor's independent per-row PRNG root."""
    return prng.fold_in(row_key(seed, row, device), 0x0C10)


def _split_rows(keys, num: int = 2):
    """keys: (B, 2) -> num independent per-row subkeys, each (B, 2)."""
    kk = prng.split(keys, num)
    return tuple(kk[:, i] for i in range(num))


def _set(t, slot: int, value):
    """``t`` with row ``slot`` set to ``value``, as a new tensor (state
    tensors alias the replay registers; never write them in place)."""
    t = t.clone()
    t[slot] = value
    return t


class StatefulModelError(ValueError):
    """A path that needs positional (KV) caches was asked to run a model
    with sequential state."""


ENCDEC_REFUSAL = ("encoder-decoder models are not served (the engine has "
                  "no encoder frames to prefill with); run them through "
                  "the model API or training")


class EncoderDecoderServingError(ValueError):
    """An encoder-decoder model was asked to serve."""


def check_servable(cfg: ModelConfig):
    """Refuse an encoder-decoder model."""
    if cfg.n_encoder_layers:
        raise EncoderDecoderServingError(f"{cfg.name}: {ENCDEC_REFUSAL}")


def ring_spare(L_max: int) -> int:
    """Slots a served sliding-window ring holds past W, for both actors.

    A key written at position r lands on ring slot r % R (R = W + spare),
    where a query at q reads it as position r - R; the window mask drops
    it whenever r - R <= q - W, i.e. r <= q + spare.  So the spare must
    cover how far past the lowest query still to come any write reaches:
      - a lockstep draft writes pos .. pos + L_max, and the next draft
        (or a replay of this one, at the same pos) starts at or after
        pos: L_max;
      - the cloud's verify writes pos .. pos + L_max in one call, all of
        its queries at or after pos: L_max;
      - a pipelined speculative draft (``draft_speculative``) starts at
        pos_next = pos + n_live + 1 <= pos + L_max + 1 and writes L_max + 1
        positions, up to pos + 2 L_max + 1.  It moves the slot's replay
        registers to its own inputs, so a later call that drafts another
        slot replays it at pos_next and rewrites the same keys; the
        lowest query still to come is the corrective draft after a miss,
        at pos + T + 1 >= pos + 1 (T accepted).  2 L_max.
    With one slot fewer, a corrective draft after a miss at T = 0 that
    follows a speculative round of L_max live drafts reads that round's
    last key as position pos + 2 - W, inside its window.  The reference
    keeps a slot's registers at pos until the verdict confirms the
    speculative round, so its replay from pos rewrites that round's keys
    with round t's drafts (ROADMAP Queue 3 item 14), and reaches
    2 L_max + 1 past its next query."""
    return 2 * L_max


def is_stateful(cfg: ModelConfig) -> bool:
    return any(b in SEQ_BLOCKS for b in cfg.block_pattern)


def rollback_cache(cache, traj, n_keep):
    """Restore every stateful layer of ``cache`` to its state after
    position ``n_keep - 1`` of ``traj`` (n_keep >= 1 tokens kept), per
    row, as new tensors.  traj: {layer index: {leaf: (B, S, ...)}}, or
    None (attention-only models: KV caches roll back by position).
    n_keep: (B,) int tensor."""
    if traj is None:
        return cache
    idx = (n_keep - 1).clamp_min(0)
    rows = torch.arange(idx.shape[0], device=idx.device)
    for i, leaves in traj.items():
        cache[i] = {name: t[rows, idx] for name, t in leaves.items()}
    return cache


# ======================================================================
# Host-side round records (what crosses between serving-loop events)
# ======================================================================
@dataclasses.dataclass
class PendingRound:
    """Edge-side record of one in-flight SD round for one slot: enough
    to apply the verdict (emit tokens) and to seed the optimistic
    continuation.  ``drafts`` has L_max+1 entries — index n_live is the
    edge's own continuation sample at the bonus position (the
    speculation guess)."""
    slot: int
    drafts: np.ndarray            # (L_max+1,) int
    betas: np.ndarray             # (L_max+1,) f32 trajectory
    n_live: int                   # L^t — drafts actually transmitted
    packed: bytes                 # the DraftPayload on the wire
    wire_bits: float              # len(packed) * 8
    t_slm: float                  # measured draft wall-clock


@dataclasses.dataclass
class SpecDraft:
    """An uncommitted speculative draft of round t+1 (optimistic
    full-accept continuation).  Committed only when the round-t verdict
    confirms the premise; otherwise dropped — its cache writes sit beyond
    the committed position and are masked/overwritten."""
    slot: int
    in_x: int                     # premise: bonus token guess
    new_key: torch.Tensor         # (2,) key chain advance on commit
    round: PendingRound           # the speculative round's record
    # calibrated-budget EMA advance, applied only on commit (so a
    # mis-speculation leaves the scale exactly where lockstep has it)
    scale_next: Dict[int, float] = dataclasses.field(default_factory=dict)


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
        self.dc, self.model = dc, model
        self.stateful = is_stateful(dc)
        self.m, self.e, self.fmt = method, engine, fmt
        self.spare = ring_spare(engine.L_max)
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
        each in-round update; for a stateful draft also "snap", each
        stateful layer's state after every step ({layer: {leaf:
        (B, L+1, ...)}}, the states the steps made, stacked once).
        keys: (B, 2) per-row PRNG keys."""
        steps = []
        snap = {i: {name: [] for name in c}
                for i, c in enumerate(self.dcache)
                if self.model.layers[i].stateful}
        tok = x_last
        for _ in range(self.e.L_max + 1):
            keys, k1 = _split_rows(keys)
            logits, self.dcache = model_mod.decode_step(self.model, tok,
                                                        self.dcache, pos)
            for i, leaves in snap.items():
                for name, ts in leaves.items():
                    ts.append(self.dcache[i][name])
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
        ys = {name: torch.stack([s[name] for s in steps])
              for name in steps[0]}
        if self.stateful:
            # popping each list as it is stacked frees the step tensors
            ys["snap"] = {i: {name: torch.stack(leaves.pop(name), 1)
                              for name in list(leaves)}
                          for i, leaves in snap.items()}
        return ys

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

    def init_slots(self, n_slots: int, cache_len: int,
                   spec: Optional[PagedSpec]):
        check_servable(self.dc)
        self._alloc_state(n_slots)
        self.cache_len = cache_len
        self.dcache = model_mod.init_cache(self.model, n_slots, cache_len,
                                           paged=spec, spare=self.spare)

    def prefill_batch(self, prompts, cache_len: int):
        check_servable(self.dc)
        B, S0 = prompts.shape
        self._alloc_state(B)
        self.cache_len = cache_len
        _, self.dcache = model_mod.prefill(self.model, prompts[:, :-1],
                                           cache_len=cache_len,
                                           spare=self.spare)
        self.x_last = prompts[:, -1].clone()
        self.pos = torch.full((B,), S0 - 1, dtype=torch.int64,
                              device=self.device)
        self.rep_x, self.rep_pos = self.x_last, self.pos

    def admit(self, slot: int, prompt, pt_row, seed: int,
              wire_codec: Optional[str] = None):
        """Prefill ``prompt`` (1-D int64 on the device) into ``slot``."""
        S0 = int(prompt.shape[0])
        _, cache1 = model_mod.prefill(self.model, prompt[None, :-1],
                                      cache_len=self.cache_len,
                                      spare=self.spare)
        model_mod.write_prefill_to_slot(self.dc, self.dcache, cache1, slot,
                                        pt_row, S0 - 1)
        key = row_key(seed, 0, self.device)
        self.x_last = _set(self.x_last, slot, prompt[-1])
        self.pos = _set(self.pos, slot, S0 - 1)
        self.beta = conformal.admit_rows(
            self.beta, torch.arange(self.B) == slot, self.m.beta0)
        self.keys = _set(self.keys, slot, key)
        self.rep_x = _set(self.rep_x, slot, prompt[-1])
        self.rep_pos = _set(self.rep_pos, slot, S0 - 1)
        self.rep_beta = _set(self.rep_beta, slot, self.m.beta0)
        self.rep_key = _set(self.rep_key, slot, key)
        self.slot_codec[slot] = wire_codec or self.fmt.codec
        self.coded_scale[slot] = 1.0

    def set_tables(self, pt):
        model_mod.set_page_tables(self.dcache, pt)

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

    def pending_round(self, batch: DraftBatch, slot: int) -> PendingRound:
        return PendingRound(slot=slot,
                            drafts=batch.drafts[:, slot].copy(),
                            betas=batch.betas[:, slot].copy(),
                            n_live=int(batch.n_live[slot]),
                            packed=batch.packed[slot],
                            wire_bits=wire_mod.packed_bits(
                                batch.packed[slot]),
                            t_slm=batch.t_slm)

    def draft_speculative(self, slot: int, x_guess: int, pos_next: int,
                          beta_next: float) -> SpecDraft:
        """Optimistic continuation: draft round t+1 under the premise
        that every live round-t draft is accepted and the bonus token
        equals the edge's own continuation sample.  Commits no stream
        state: the key chain advance and the calibrated scale are stored
        in the record and applied only by ``commit_speculative`` when the
        verdict confirms the premise.  The slot's replay registers move
        to this round's inputs now, as they name the last round that
        wrote the slot's cache: a replay rewrites this round's KV bit for
        bit.  On a miss the corrective draft starts at pos + T + 1 <=
        pos_next, writes every position before a later query reads it,
        and resets the registers; in paged mode the miss's shrink maps
        the speculative pages past the kept length to the trash page
        before the next call pushes the tables, so a replay before that
        draft writes into no page another slot holds."""
        if self.stateful:
            raise StatefulModelError(
                "speculative continuation requires a positional (KV) draft "
                "cache: sequential-state drafts must run lockstep")
        onehot = np.zeros((self.B,), bool)
        onehot[slot] = True
        dev = self.device
        mj = torch.as_tensor(onehot, device=dev)
        x_in = torch.where(mj, torch.tensor(int(x_guess), device=dev),
                           self.rep_x)
        pos_in = torch.where(mj, torch.tensor(int(pos_next), device=dev),
                             self.rep_pos)
        beta_in = torch.where(mj, torch.tensor(float(beta_next),
                                               dtype=torch.float32,
                                               device=dev), self.rep_beta)
        key_in = torch.where(mj[:, None], self.keys, self.rep_key)
        ys, new_keys, t_slm = self._run_draft(x_in, pos_in, beta_in, key_in)
        # the registers name the last round that wrote the slot's cache
        self.rep_x, self.rep_pos, self.rep_beta = x_in, pos_in, beta_in
        self.rep_key = key_in
        batch = self._build_batch(ys, onehot, t_slm)
        return SpecDraft(slot=slot, in_x=int(x_guess),
                         new_key=new_keys[slot].clone(),
                         round=self.pending_round(batch, slot),
                         scale_next=batch.scale_next)

    def commit_speculative(self, spec: SpecDraft):
        """The verdict confirmed the premise: advance the key chain and
        the calibrated scale exactly as a real draft() commit would have
        (the replay registers already hold the speculative round's
        inputs, set when it was drafted)."""
        self.keys = _set(self.keys, spec.slot, spec.new_key)
        self.commit_scales(spec.scale_next)

    # -- verdict application -------------------------------------------
    def apply_verdict_slot(self, slot: int,
                           verdict: wire_mod.VerdictPayload,
                           rec: PendingRound) -> List[int]:
        """Per-slot verdict (event-driven serving).  Positional caches
        need no rollback; sequential-state drafts are lockstep-only."""
        if self.stateful:
            raise StatefulModelError(
                "per-slot verdicts require a positional (KV) draft cache: "
                "sequential-state drafts must run lockstep")
        T = int(verdict.n_accept)
        self.pos = _set(self.pos, slot, self.pos[slot] + T + 1)
        self.x_last = _set(self.x_last, slot, int(verdict.new_token))
        if self.m.name == "csqs":
            self.beta = _set(self.beta, slot, float(np.float32(
                verdict.beta_next)))
        return [int(t) for t in rec.drafts[:T]] + [int(verdict.new_token)]

    def apply_verdicts_batch(self, mask: np.ndarray,
                             verdicts: Dict[int, wire_mod.VerdictPayload],
                             batch: DraftBatch) -> List[List[int]]:
        """Whole-batch verdict application: rollback of the stateful
        layers to the snapshot after the last kept token (rows outside
        ``mask`` to the one after their replayed token), β resume from
        the wire, position/x_last advance, token emission.  (Positional
        KV caches need no rollback.)"""
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
        T = torch.from_numpy(T_np).to(dev)
        self.dcache = rollback_cache(self.dcache, batch.ys.get("snap"),
                                     torch.where(mj, T, 0) + 1)
        if self.m.name == "csqs":
            self.beta = torch.where(mj, torch.from_numpy(beta_np).to(dev),
                                    self.beta)
        self.pos = self.pos + torch.where(mj, T + 1, 0)
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
        self.tc, self.model = tc, model
        self.stateful = is_stateful(tc)
        self.m, self.e, self.fmt = method, engine, fmt
        self.spare = ring_spare(engine.L_max)
        self.seed = seed
        self.V = tc.vocab
        self.device = resolve_device(device)

    def _verify_round(self, tokens_in, pos, q_hat, live, keys):
        """tokens_in: (B, L+1) = [x_last, d_1..d_L].  Returns (verify
        result, p, the state trajectory of a stateful target or None)."""
        logits, self.tcache, traj = model_mod.extend_step(
            self.model, tokens_in, self.tcache, pos,
            collect_traj=self.stateful)
        p = sqs_mod.softmax_temp(logits, self.e.temperature)  # (B, L+1, V)
        return (verify_mod.verify(keys, tokens_in[:, 1:], q_hat, p, live), p,
                traj if self.stateful else None)

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

    def init_slots(self, n_slots: int, cache_len: int,
                   spec: Optional[PagedSpec]):
        check_servable(self.tc)
        self._alloc_state(n_slots)
        self.cache_len = cache_len
        self.tcache = model_mod.init_cache(self.model, n_slots, cache_len,
                                           paged=spec, spare=self.spare)

    def prefill_batch(self, prompts, cache_len: int):
        check_servable(self.tc)
        B, S0 = prompts.shape
        self._alloc_state(B)
        self.cache_len = cache_len
        _, self.tcache = model_mod.prefill(self.model, prompts[:, :-1],
                                           cache_len=cache_len,
                                           spare=self.spare)
        self.x_last = prompts[:, -1].clone()
        self.pos = torch.full((B,), S0 - 1, dtype=torch.int64,
                              device=self.device)
        self.rep_x, self.rep_pos = self.x_last, self.pos

    def admit(self, slot: int, prompt, pt_row, seed: int,
              wire_codec: Optional[str] = None):
        S0 = int(prompt.shape[0])
        _, cache1 = model_mod.prefill(self.model, prompt[None, :-1],
                                      cache_len=self.cache_len,
                                      spare=self.spare)
        model_mod.write_prefill_to_slot(self.tc, self.tcache, cache1, slot,
                                        pt_row, S0 - 1)
        self.slot_codec[slot] = wire_codec or self.fmt.codec
        key = cloud_row_key(seed, 0, self.device)
        self.x_last = _set(self.x_last, slot, prompt[-1])
        self.pos = _set(self.pos, slot, S0 - 1)
        self.keys = _set(self.keys, slot, key)
        self.rep_tokens = _set(self.rep_tokens, slot, 0)
        self.rep_qhat = _set(self.rep_qhat, slot, 0.0)
        self.rep_live = _set(self.rep_live, slot, False)
        self.rep_x = _set(self.rep_x, slot, prompt[-1])
        self.rep_pos = _set(self.rep_pos, slot, S0 - 1)
        self.rep_key = _set(self.rep_key, slot, key)

    def set_tables(self, pt):
        model_mod.set_page_tables(self.tcache, pt)

    def verify(self, mask: np.ndarray,
               payloads: Dict[int, wire_mod.DraftPayload],
               collect_p: bool = False) -> VerifyBatch:
        """Verify the rows in ``mask`` against their unpacked payloads;
        other rows replay their registers.  Rolls a stateful target back
        to the state after the last kept token.  Packs one verdict per
        payload, including the Alg.-1 β backtrack from the wire
        trajectory."""
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
        res, p_dists, traj = self._verify_round(tokens_in, pos_in, qhat,
                                                live, kv)
        _sync(dev)
        t_llm = time.perf_counter() - t0
        T = res.n_accept.to(torch.int64)
        self.tcache = rollback_cache(self.tcache, traj,
                                     torch.where(mj, T, 0) + 1)
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
# Edge-side base: slot lifecycle + per-slot round steps
# ======================================================================
class EdgeEngineBase:
    """Everything the serving loops need from the EDGE side of the link:
    format negotiation, the draft actor, the slot lifecycle, per-slot
    drafting, speculative continuation and verdict application.

    ``EdgeCloudEngine`` below extends it with the in-process cloud
    actor; a socket-transport engine extends it the same way, with its
    verify side in another process.  Sharing this class is what keeps
    the two bit-identical: there is one implementation of every
    token-affecting edge step, and subclasses only override how the
    verify peer is reached (``_init_peer_slots`` / ``_admit_peer`` /
    ``_push_tables``)."""

    def __init__(self, draft_cfg: ModelConfig, draft_model,
                 method: MethodConfig, engine: EngineConfig,
                 channel: channel_mod.ChannelConfig, seed: int,
                 device="cuda"):
        assert engine.wire_codec in wire_mod.CODECS, engine.wire_codec
        assert engine.budget_model in ("analytic", "calibrated"), \
            engine.budget_model
        self.device = resolve_device(device)
        self.dc = draft_cfg
        self.m, self.e, self.ch = method, engine, channel
        self.seed = seed
        self.V = draft_cfg.vocab
        self.fmt = wire_mod.WireFormat(
            V=self.V, ell=method.ell, L_max=engine.L_max,
            mode="raw" if method.name == "uncompressed" else "lattice",
            codec=engine.wire_codec)
        self.edge = EdgeDraftEngine(draft_cfg, draft_model, method, engine,
                                    self.fmt, seed, self.device)
        # does the verify-side model carry recurrent state? (subclasses
        # set it)
        self.peer_stateful = False
        self.paged = False
        self.alloc: Optional[PageAllocator] = None

    # -- state passthroughs (tests read these) ---------------------------
    @property
    def beta(self):
        return self.edge.beta

    @property
    def pos(self):
        return self.edge.pos

    @property
    def x_last(self):
        return self.edge.x_last

    @property
    def dcache(self):
        return self.edge.dcache

    # ------------------------------------------------------------------
    # Session-slot API (continuous batching — repro_torch.serve)
    # ------------------------------------------------------------------
    def init_slots(self, n_slots: int, cache_len: int,
                   page_size: int = 0, n_pages: Optional[int] = None):
        """Allocate ``n_slots`` empty session slots with per-slot cache
        capacity ``cache_len``.  Slots are filled by admit_slot and freed
        by release_slot; rounds only advance committed slots.

        ``page_size > 0`` switches the attention layers to the PAGED
        layout: one shared pool of ``n_pages`` pages per layer (default:
        slots × pages-per-slot, the dense footprint).  The edge and cloud
        actors mirror ONE allocator, so the device holds the sum of
        actual request lengths and ``n_pages`` caps concurrency."""
        self.B = n_slots
        self.paged = page_size > 0
        spec = None
        if self.paged:
            assert cache_len % page_size == 0, (cache_len, page_size)
            maxp = cache_len // page_size
            n_pages = n_pages if n_pages is not None else n_slots * maxp
            assert n_pages >= maxp, \
                "pool must fit at least one worst-case request"
            spec = PagedSpec(page_size=page_size, n_pages=n_pages,
                             max_pages_per_slot=maxp)
            self.alloc = PageAllocator(n_pages, page_size, n_slots, maxp)
        else:
            self.alloc = None
        self.cache_len = cache_len
        self.edge.init_slots(n_slots, cache_len, spec)
        self._init_peer_slots(n_slots, cache_len, spec)
        self.active = np.zeros((n_slots,), bool)
        self.out_tokens = [[] for _ in range(n_slots)]

    def _init_peer_slots(self, n_slots: int, cache_len: int,
                         spec: Optional[PagedSpec]):
        """Hook: mirror the slot allocation on the verify side."""

    # -- paged-pool bookkeeping (host side; no-ops in dense mode) -------
    def _device_tables(self):
        return sanitize_page_table(self.alloc.table, self.alloc.n_pages,
                                   self.device)

    def _push_tables(self):
        self.edge.set_tables(self._device_tables())

    def pages_needed(self, n_tokens: int) -> int:
        assert self.paged
        return self.alloc.pages_needed(n_tokens)

    def free_pages(self) -> int:
        assert self.paged
        return self.alloc.free_pages

    def ensure_slot_capacity(self, slot: int, n_tokens: int) -> bool:
        """Per-slot page growth (event-driven serving)."""
        if not self.paged:
            return True
        return self.alloc.ensure(slot, n_tokens)

    def ensure_round_capacity(self) -> bool:
        """Grow every active slot's page table to cover this round's
        draft window (pos + L_max + 1 positions).  Returns False on pool
        exhaustion WITHOUT rolling back other slots' growth — the
        serving layer preempts a request and retries."""
        if not self.paged:
            return True
        pos = self.pos.cpu().numpy()
        for slot in range(self.B):
            if not self.active[slot]:
                continue
            if not self.alloc.ensure(slot,
                                     int(pos[slot]) + self.e.L_max + 1):
                return False
        return True

    def admit_slot(self, slot: int, prompt, seed: int,
                   wire_codec: Optional[str] = None):
        """Prefill ``prompt`` (1-D ints, ≥ 2 tokens) into ``slot`` on
        BOTH sides of the link.  The request's RNG/β/position state
        restarts from scratch; other slots' caches and controller state
        are untouched.  ``wire_codec`` overrides the link's negotiated
        codec version for this request.

        Capacity contract: each round writes draft KV up to pos + L_max,
        so the CALLER bounds generation length such that prompt +
        generated + L_max + 1 fits in cache_len (ServeSession enforces
        this from the request's max_new_tokens)."""
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                                 device=self.device)
        assert prompt.dim() == 1 and prompt.shape[0] >= 2
        assert not self.active[slot], f"slot {slot} still occupied"
        S0 = int(prompt.shape[0])
        assert S0 + self.e.L_max + 1 <= self.cache_len, \
            f"prompt ({S0}) + draft window ({self.e.L_max + 1}) exceeds " \
            f"slot capacity {self.cache_len}"
        assert wire_codec is None or wire_codec in wire_mod.CODECS, \
            wire_codec
        pt_row = None
        if self.paged:
            if not self.alloc.admit(slot, S0 - 1):
                raise RuntimeError(
                    f"page pool exhausted admitting slot {slot} "
                    f"({self.alloc.free_pages} free); the scheduler "
                    f"should gate admissions on free_pages()")
            pt_row = self._device_tables()[slot]
        self.edge.admit(slot, prompt, pt_row, seed, wire_codec=wire_codec)
        self._admit_peer(slot, prompt, pt_row, seed, wire_codec)
        self.active[slot] = True
        self.out_tokens[slot] = []

    def _admit_peer(self, slot: int, prompt, pt_row, seed: int,
                    wire_codec: Optional[str]):
        """Hook: mirror the admission on the verify side."""

    def release_slot(self, slot: int):
        """Evict a finished (or preempted) request.  Dense mode: the
        slot's cache is dead weight until the next admit overwrites it.
        Paged mode: every page returns to the pool immediately."""
        self.active[slot] = False
        if self.paged:
            self.alloc.release(slot)

    # ------------------------------------------------------------------
    # Per-slot round steps (event-driven serving — repro_torch.serve.events)
    # ------------------------------------------------------------------
    def draft_slots(self, slots: List[int]) -> Dict[int, PendingRound]:
        """Draft one round for ``slots`` (each on its own edge device);
        returns the packed uplink message + emission record per slot."""
        mask = np.zeros((self.B,), bool)
        mask[list(slots)] = True
        if self.paged:
            pos = self.pos.cpu().numpy()
            for s in slots:
                ok = self.alloc.ensure(s, int(pos[s]) + self.e.L_max + 1)
                assert ok, "page pool exhausted — the event loop's " \
                    "worst-case admission gate should prevent this"
            self._push_tables()
        batch = self.edge.draft(mask)
        return {s: self.edge.pending_round(batch, s) for s in slots}

    def draft_speculative_slot(self, slot: int,
                               rec: PendingRound) -> Optional[SpecDraft]:
        """Optimistic continuation for ``slot`` while its round is in
        flight.  Returns None when speculation is unsafe (a stateful draft
        or target) or the window would exceed the slot's capacity or the
        page pool."""
        if self.edge.stateful or self.peer_stateful:
            return None
        n = rec.n_live
        pos_next = int(self.pos[slot]) + n + 1
        if pos_next + self.e.L_max + 1 > self.cache_len:
            return None
        if self.paged:
            if not self.alloc.ensure(slot, pos_next + self.e.L_max + 1):
                return None
            self._push_tables()
        return self.edge.draft_speculative(
            slot, int(rec.drafts[n]), pos_next, float(rec.betas[n]))

    def commit_speculative(self, spec: SpecDraft):
        self.edge.commit_speculative(spec)

    def spec_premise_holds(self, spec: SpecDraft, rec: PendingRound,
                           verdict: wire_mod.VerdictPayload) -> bool:
        """Was the optimistic continuation drafted from the true state?
        (β agreement is implied: accept-all backtracks to the same
        trajectory entry the speculation resumed from.)"""
        return (verdict.n_accept == rec.n_live
                and verdict.new_token == spec.in_x)

    def unpack_verdict_slot(self, slot: int,
                            data: bytes) -> wire_mod.VerdictPayload:
        return self.fmt.unpack_verdict(data,
                                       codec=self.edge.slot_codec[slot])

    def unpack_verdict_batch(self, data: bytes):
        """Edge side: decode a cell's frame back to ascending-slot
        (slot, VerdictPayload) pairs."""
        return self.fmt.unpack_verdict_batch(data, self.B)

    def apply_verdict_slot(self, slot: int,
                           verdict: wire_mod.VerdictPayload,
                           rec: PendingRound,
                           shrink: bool = True) -> List[int]:
        """Edge side of verdict arrival: emit tokens, resume β, shrink
        the slot's pages past the kept length.  ``shrink=False`` keeps
        the grown window — the event loop passes it when a confirmed
        speculative round's draft KV lives in those pages."""
        emitted = self.edge.apply_verdict_slot(slot, verdict, rec)
        self.out_tokens[slot].extend(emitted)
        if self.paged and shrink:
            self.alloc.shrink(slot, int(self.pos[slot]))
        return emitted


# ======================================================================
# Facade: slot lifecycle + lockstep rounds over the wire
# ======================================================================
class EdgeCloudEngine(EdgeEngineBase):
    """Owns the two actors, the slot lifecycle and the (mirrored) page
    allocator; moves packed payloads between them.  ``run_round`` is the
    lockstep schedule of Algorithm 1; the event-driven pipelined
    schedule lives in ``repro_torch.serve.events`` and drives the
    per-slot methods instead."""

    def __init__(self, draft_cfg: ModelConfig, draft_model,
                 target_cfg: ModelConfig, target_model,
                 method: MethodConfig, engine: EngineConfig = EngineConfig(),
                 channel: channel_mod.ChannelConfig =
                 channel_mod.ChannelConfig(),
                 seed: int = 0, device="cuda"):
        assert draft_cfg.vocab == target_cfg.vocab, "shared vocabulary"
        super().__init__(draft_cfg, draft_model, method, engine, channel,
                         seed, device)
        self.tc = target_cfg
        self.cloud = CloudVerifyEngine(target_cfg, target_model, method,
                                       engine, self.fmt, seed, self.device)
        self.peer_stateful = self.cloud.stateful

    @property
    def tcache(self):
        return self.cloud.tcache

    def prefill(self, prompts):
        """prompts: (B, S0) ints.  Prepares both actors; the last prompt
        token becomes x_last (first token the draft loop processes)."""
        prompts = torch.as_tensor(np.array(prompts), dtype=torch.int64,
                                  device=self.device)
        B, S0 = prompts.shape
        self.B = B
        self.paged = False
        self.alloc = None
        total = S0 + 4096  # cache capacity headroom
        self.edge.prefill_batch(prompts, total)
        self.cloud.prefill_batch(prompts, total)
        self.active = np.ones((B,), bool)
        self.out_tokens = [[] for _ in range(B)]

    # -- verify-side hooks (the in-process cloud actor) -----------------
    def _init_peer_slots(self, n_slots: int, cache_len: int,
                         spec: Optional[PagedSpec]):
        self.cloud.init_slots(n_slots, cache_len, spec)

    def _admit_peer(self, slot: int, prompt, pt_row, seed: int,
                    wire_codec: Optional[str]):
        self.cloud.admit(slot, prompt, pt_row, seed, wire_codec=wire_codec)

    def _push_tables(self):
        pt = self._device_tables()
        self.edge.set_tables(pt)
        self.cloud.set_tables(pt)

    def verify_slots(self, packed: Dict[int, bytes]) -> VerifyBatch:
        """Cloud side of one round for the slots whose payloads arrived:
        unpack (with each slot's negotiated codec), verify, pack
        verdicts."""
        mask = np.zeros((self.B,), bool)
        mask[list(packed)] = True
        if self.paged:
            self._push_tables()
        payloads = wire_mod.unpack_drafts(
            self.fmt, packed,
            codecs={s: self.cloud.slot_codec[s] for s in packed})
        return self.cloud.verify(mask, payloads)

    # -- per-slot verdict codec and verdict batching ---------------------
    def pack_verdict_slot(self, slot: int,
                          v: wire_mod.VerdictPayload) -> bytes:
        return self.fmt.pack_verdict(v, codec=self.cloud.slot_codec[slot])

    def pack_verdict_batch(self, verdicts: Dict[int,
                                                wire_mod.VerdictPayload]
                           ) -> bytes:
        """Cloud side: one cell's verdicts in ascending slot order (the
        deterministic frame order both ends rely on), one frame coded
        with the LINK's negotiated codec."""
        return self.fmt.pack_verdict_batch(sorted(verdicts.items()), self.B)

    # ------------------------------------------------------------------
    def run_round(self, verdict_groups: Optional[List[List[int]]] = None):
        """One lockstep SD batch over the ACTIVE rows, through the wire.
        Returns a metrics dict (host values).  Inactive slots still flow
        through the compute (static shapes, replaying their registers)
        but are masked out of budgets, state advancement and every
        reported statistic.  ``verdict_groups``: lists of
        slots sharing a downlink; each group's verdicts cross as ONE coded
        frame, and the edge applies the frame-decoded verdicts."""
        L = self.e.L_max
        active = np.asarray(self.active, bool)
        n_active = max(int(active.sum()), 1)
        if self.paged:
            if not self.ensure_round_capacity():
                raise RuntimeError(
                    "page pool exhausted growing the round's draft "
                    "windows; preempt a request (ServeSession does) "
                    "before run_round")
            self._push_tables()

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
        if self.paged:
            # speculative rollback, memory side: pages covering only the
            # rejected draft tail (positions >= new pos) go back to the
            # pool; the next round's ensure re-grows as needed
            pos_np = self.pos.cpu().numpy()
            for slot in range(self.B):
                if active[slot]:
                    self.alloc.shrink(slot, int(pos_np[slot]))

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
        if self.paged:
            metrics["pages_in_use"] = self.alloc.pages_in_use
            metrics["free_pages"] = self.alloc.free_pages
            metrics["peak_pages_in_use"] = self.alloc.peak_in_use
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
