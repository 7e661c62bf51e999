"""Sliding-window attention against the reference, in float32 on the
CPU, at the smoke ``qwen2.5-3b`` with ``attention="sliding"``,
parameters carried across by ``bridge.from_jax``:

- ``masked_attention`` with a window (and a key-validity mask) against
  ``repro.models.attention.masked_attention``;
- the ring: a prefill longer than W leaves the reference's ring of roped
  keys (dense and int8), ``decode_step``s through the ring past W give the
  reference's logits (ATOL, as tests/test_torch_model.py) and the
  windowed teacher-forced logits (the reference's tests/test_models.py
  ring test, 2e-4), and W >= S equals full attention;
- the wrap-after-rejection fault of the reference, mirrored at the
  model's default ``spare=0``: a rejected 3-token draft on a wrapped ring
  gives the reference's (wrong) logits, on a ring that has not wrapped
  the clean path's; with the engine's spare (``core.engine.ring_spare``)
  the same draft on a wrapped ring gives the windowed recompute's;
- a ring of W + spare equals a cache that never wraps;
- ``INPUT_SHAPES``, ``for_shape`` and ``supports_shape`` equal to the
  reference's for every architecture the port registers;
- the engine serves a sliding-window pair past its window, fixed batch
  and slots, lockstep and pipelined with speculation, in rounds that
  reject (K-SQS) and that accept (uncompressed at a 1e9-bit budget):
  every committed row's draft q and target p equal the tempered softmax
  of the reference's windowed teacher-forced logits on the same tokens;
  with the spare one slot short the pipelined path does not; the same
  past the wrap over TCP; and a trace at cache_len <= W equals the
  reference's streams and summary.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core import EdgeCloudEngine as RefEngine  # noqa: E402
from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core import MethodConfig as RefMethodConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,  # noqa: E402
                                     MethodConfig, ring_spare)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

ATOL = 1e-4
ORACLE_ATOL = 2e-4              # the reference's ring test
# an int8 cache is read as bf16 with bf16 probabilities (the reference's
# path), so a change of call shape or key order flips bf16 roundings and
# moves a float32 logit by a few 1e-3; the reference's int8 kernel
# tolerance (tests/test_kernels.py).  One lost key moves it by far more
INT8_ATOL = 2e-2
TOL = {"compute": ORACLE_ATOL, "int8": INT8_ATOL}
ARCH = "qwen2.5-3b"
# the reference's ring test: W 8, 24 tokens, a 12-token prefill
W, S, S0 = 8, 24, 12
CSQS = dict(name="csqs", alpha=5e-3, eta=5e-2)
TRACE = dict(n_requests=4, rate_rps=6.0, prompt_len=10, min_new_tokens=3,
             max_new_tokens=7, vocab=512, seed=3)
# the engine tests: drafts a round and the engine's ring spare for them
L_MAX = 3
SPARE = ring_spare(L_MAX)
# rounds that reject (K-SQS) and rounds that accept (every draft sent,
# uncompressed, as chip_smoke.py's rollback phase)
REJECT = (dict(name="ksqs", K=8, ell=100), 5000.0)
ACCEPT = (dict(name="uncompressed"), 1e9)
# past the wrap: prompts of PAST tokens fill a ring of 64 + SPARE slots
# twice over before the first round, and the rounds cross its next wrap
PAST = 150
PAST_TRACE = dict(n_requests=4, rate_rps=6.0, prompt_len=PAST,
                  min_new_tokens=6, max_new_tokens=10, vocab=512, seed=3)
PAST_CACHE = PAST + 10 + L_MAX + 1 + 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(window, draft=False, **over):
    jc = jconfigs.smoke_variant(jconfigs.get_config(ARCH))
    tc = configs.smoke_variant(configs.get_config(ARCH))
    if draft:
        jc, tc = jconfigs.draft_variant(jc, 2), configs.draft_variant(tc, 2)
    if window:
        over = dict(over, attention="sliding", sliding_window=window)
    jc, tc = dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _bridged(window, draft=False, seed=0, **over):
    jc, tc = _cfgs(window, draft, **over)
    params = jax.tree.map(np.asarray,
                          jmodel.init_params(jc, jax.random.PRNGKey(seed)))
    return jc, jax.tree.map(jnp.asarray, params), \
        bridge.from_jax(params, tc, device="cpu")


def _tokens(vocab, n=S):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, n), 0,
                                         vocab))


@pytest.mark.parametrize("window,valid", [(0, False), (3, False), (5, True),
                                          (16, False)])
def test_masked_attention_matches_reference(window, valid):
    rng = np.random.default_rng(window)
    B, Sq, nq, nkv, hd, hdv = 2, 12, 4, 2, 16, 8
    q = rng.standard_normal((B, Sq, nq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sq, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sq, nkv, hdv)).astype(np.float32)
    pos = (np.arange(Sq)[None] + np.array([[0], [5]])).astype(np.int32)
    k_valid = rng.random((B, Sq)) < 0.8 if valid else None
    if valid:
        k_valid[:, 0] = True                    # no query sees no key
    ref = jattn.masked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), causal=True, window=window,
        k_valid=None if k_valid is None else jnp.asarray(k_valid))
    got = tattn.masked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos).long(), torch.from_numpy(pos).long(),
        causal=True, window=window,
        k_valid=None if k_valid is None else torch.from_numpy(k_valid))
    assert got.shape == (B, Sq, nq, hdv)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_ring_prefill_and_decode_match_reference(kv):
    jc, jp, m = _bridged(W, kv_cache_dtype=kv)
    toks = _tokens(jc.vocab)
    full = jmodel.forward_logits(jc, jp, jnp.asarray(toks))
    got_full = tmodel.forward_logits(m, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got_full.numpy(), np.asarray(full), atol=ATOL)
    lj, cj = jmodel.prefill(jc, jp, jnp.asarray(toks[:, :S0]), cache_len=S)
    lt, ct = tmodel.prefill(m, torch.from_numpy(toks[:, :S0]).long(),
                            cache_len=S)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    for i, c in enumerate(ct):
        for name, t in c.items():
            ref = np.asarray(cj["body"]["p0"][name][i])
            assert t.shape == ref.shape and t.shape[1] == W   # the ring
            np.testing.assert_allclose(t.float().numpy(),
                                       ref.astype(np.float32), atol=ATOL)
    pos = np.full((1,), S0, np.int32)
    for t in range(S0, S - 1):
        lj, cj = jmodel.decode_step(jc, jp, jnp.asarray(toks[:, t]), cj,
                                    jnp.asarray(pos))
        lt, ct = tmodel.decode_step(m, torch.from_numpy(toks[:, t]).long(),
                                    ct, torch.from_numpy(pos).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
        if kv == "compute":
            np.testing.assert_allclose(lt.numpy(), got_full[:, t].numpy(),
                                       atol=ORACLE_ATOL)
        pos = pos + 1


def test_window_wider_than_sequence_is_full_attention():
    """tests/test_models.py's W >= S check, on the port."""
    _, _, full = _bridged(0)
    _, _, wide = _bridged(64)
    toks = torch.from_numpy(_tokens(512, 12)).long()
    np.testing.assert_allclose(tmodel.forward_logits(wide, toks).numpy(),
                               tmodel.forward_logits(full, toks).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("window", [W, 64], ids=["wraps", "no-wrap"])
def test_wrap_after_rejection_mirrors_reference(window):
    """Prefill 12 tokens, verify the true token plus 3 junk drafts at
    position 12, keep 1 and decode the true token 13: the port gives the
    reference's logits; once the ring has wrapped both are far from the
    clean path's (the rejected drafts overwrote keys still in the window),
    before it they are the clean path's."""
    jc, jp, m = _bridged(window)
    toks = _tokens(jc.vocab)
    clean = tmodel.forward_logits(m, torch.from_numpy(toks).long())[:, 13]
    verify = np.array([[toks[0, S0], 5, 6, 7]], np.int32)
    _, cj = jmodel.prefill(jc, jp, jnp.asarray(toks[:, :S0]), cache_len=S)
    _, cj = jmodel.extend_step(jc, jp, jnp.asarray(verify), cj,
                               jnp.asarray([S0], jnp.int32))
    ref, _ = jmodel.decode_step(jc, jp, jnp.asarray(toks[:, S0 + 1]), cj,
                                jnp.asarray([S0 + 1], jnp.int32))
    _, ct = tmodel.prefill(m, torch.from_numpy(toks[:, :S0]).long(),
                           cache_len=S)
    _, ct, _ = tmodel.extend_step(m, torch.from_numpy(verify).long(), ct,
                                  torch.tensor([S0]))
    got, _ = tmodel.decode_step(m, torch.from_numpy(toks[:, S0 + 1]).long(),
                                ct, torch.tensor([S0 + 1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    gap = float((got - clean).abs().max())
    if window == W:
        assert gap > 0.5, gap                  # 2.92 in the reference
    else:
        assert gap < ORACLE_ATOL, gap


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_rejection_on_the_spare_ring_matches_recompute(kv):
    """The mirror test's rejected 3-token draft (L_max 3) on a ring of W +
    ring_spare(3) slots that wrapped in its 20-token prefill: every decode
    after keeping 1 token gives the windowed teacher-forced logits (the
    reference's ``forward_logits`` in float; for int8, whose quantization
    moves logits by more than ORACLE_ATOL, the same int8 cache sized
    never to wrap), within TOL."""
    jc, jp, m = _bridged(W, kv_cache_dtype=kv)
    toks = _tokens(jc.vocab)
    S1 = 20
    verify = torch.tensor([[int(toks[0, S1]), 5, 6, 7]])
    t_toks = torch.from_numpy(toks).long()
    _, ring = tmodel.prefill(m, t_toks[:, :S1], cache_len=S, spare=SPARE)
    assert ring[0]["k"].shape[1] == W + SPARE < S1      # wrapped
    _, ring, _ = tmodel.extend_step(m, verify, ring, torch.tensor([S1]))
    if kv == "compute":
        want = np.asarray(jmodel.forward_logits(jc, jp, jnp.asarray(toks)))
    else:
        _, flat = tmodel.prefill(m, t_toks[:, :S1], cache_len=S, spare=S)
        want = np.zeros((1, S, jc.vocab), np.float32)
        for t in range(S1, S):
            lg, flat = tmodel.decode_step(m, t_toks[:, t], flat,
                                          torch.tensor([t]))
            want[:, t] = lg.numpy()
    for t in range(S1 + 1, S):
        got, ring = tmodel.decode_step(m, t_toks[:, t], ring,
                                       torch.tensor([t]))
        np.testing.assert_allclose(got.numpy(), want[:, t], atol=TOL[kv])


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_ring_with_spare_equals_a_cache_that_never_wraps(kv):
    """A ring of W + spare slots and a cache of every position, under the
    same window mask, driven by the same calls past three wraps (a draft's
    L_max + 1 decode steps, then a verify of L_max + 1 tokens, rolled back
    to 1-3 kept tokens a round): equal logits within 1e-5 (int8: within
    INT8_ATOL, its bf16 roundings flipping under another key order)."""
    _, _, m = _bridged(W, kv_cache_dtype=kv)
    toks = torch.from_numpy(_tokens(512, 64)).long()
    S_end, pos = 60, 12
    caches = [tmodel.prefill(m, toks[:, :pos], cache_len=S_end + 8,
                             spare=sp)[1] for sp in (SPARE, S_end + 8)]
    assert caches[0][0]["k"].shape[1] == W + SPARE
    assert caches[1][0]["k"].shape[1] == S_end + 8
    worst, r = 0.0, 0
    while pos + 2 * L_MAX + 2 < S_end:
        junk = (torch.arange(L_MAX) + 7 * r + 1) % 512
        outs = [[], []]
        for i, c in enumerate(caches):
            x = toks[:, pos]
            for j in range(L_MAX + 1):
                lg, c = tmodel.decode_step(m, x, c, torch.tensor([pos + j]))
                outs[i].append(lg)
                x = junk[j % L_MAX][None]
            lg, c, _ = tmodel.extend_step(
                m, torch.cat([toks[:, pos], junk])[None], c,
                torch.tensor([pos]))
            outs[i].append(lg[0])
        for a, b in zip(*outs):
            worst = max(worst, float((a - b).abs().max()))
        pos, r = pos + 1 + r % 3, r + 1
    tol = 1e-5 if kv == "compute" else INT8_ATOL
    assert pos > 3 * (W + SPARE) and worst <= tol, (pos, worst)


class _Shards:
    """``sharding.local.ContextShards`` for ranks run as threads: rank
    ``i`` of ``n`` holds ring slots [offset, offset + Sc) of ``total``;
    ``reduce`` meets the other ranks at a barrier."""

    def __init__(self, i, offset, total, board, barrier):
        self.i, self.offset, self.total = i, offset, total
        self.board, self.barrier = board, barrier

    def reduce(self, t, op):
        self.board[self.i] = t
        self.barrier.wait()
        parts = list(self.board)
        self.barrier.wait()
        return torch.stack(parts).amax(0) if op == "max" \
            else torch.stack(parts).sum(0)


def test_context_parallel_ring_with_spare_equals_one_rank():
    """``_extend_attn``'s context-parallel branch (the dry run's
    sequence-sharded cache) on a ring of W + spare slots split over two
    ranks at an uneven cut: each rank's output equals the unsharded
    attention over the whole ring within 1e-5, queries past its third
    wrap."""
    import threading
    rng = np.random.default_rng(5)
    R, nq, nkv, hd = W + SPARE, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((1, 4, nq, hd), np.float32))
    ck, cv = (torch.from_numpy(rng.standard_normal((1, R, nkv, hd),
                                                   np.float32))
              for _ in range(2))
    abs_new = torch.tensor([[3 * R + 2 + j for j in range(4)]])
    want = tattn._extend_attn(q, ck, cv, abs_new, W)
    cut, board, barrier, got = 6, [None, None], threading.Barrier(2), {}

    def rank(i):
        a, b = (0, cut) if i == 0 else (cut, R)
        cp = _Shards(i, a, R, board, barrier)
        got[i] = tattn._extend_attn(q, ck[:, a:b], cv[:, a:b], abs_new, W,
                                    cp)
    threads = [threading.Thread(target=rank, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in (0, 1):
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), atol=1e-5)


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in
            configs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in
         jconfigs.INPUT_SHAPES.items()}
    for name in configs.list_configs():
        port, ref = configs.get_config(name), jconfigs.get_config(name)
        for shape in configs.INPUT_SHAPES:
            got = configs.for_shape(port, configs.INPUT_SHAPES[shape])
            want = jconfigs.for_shape(ref, jconfigs.INPUT_SHAPES[shape])
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert configs.supports_shape(
                port, configs.INPUT_SHAPES[shape]) == jconfigs.supports_shape(
                    ref, jconfigs.INPUT_SHAPES[shape])
    long = configs.for_shape(configs.get_config(ARCH),
                             configs.INPUT_SHAPES["long_500k"])
    assert (long.attention, long.sliding_window) == ("sliding", 8192)


def _engine(window_target, window_draft, method=CSQS, budget=5000.0,
            collect=False, **over):
    _, _, tm = _bridged(window_target, seed=1, **over)
    _, _, dm = _bridged(window_draft, draft=True, seed=2, **over)
    return EdgeCloudEngine(dm.cfg, dm, tm.cfg, tm, MethodConfig(**method),
                           EngineConfig(L_max=L_MAX, bit_budget=budget,
                                        collect_theory=collect),
                           seed=0, device="cpu")


class _Rounds:
    """Wraps an engine to keep, for every committed row of every draft
    call (speculative ones too) and every verify call, the token sequence
    the row's distributions condition on, the position of its first
    query and its dense log-distributions (the draft's q per step with
    ``collect_theory``, the target's p per position), and each verify
    row's accepted count and whether it rejected a draft."""

    def __init__(self, eng):
        self.eng = eng
        self.prompt = {}
        self.rows = {"draft": [], "target": []}
        self.n_accept, self.rejected, self.n_spec = [], [], 0
        self._ys = self._premise = self._mask = None
        edge, cloud = eng.edge, eng.cloud
        self._wrap(eng, "prefill", self._on_prefill)
        self._wrap(eng, "admit_slot", self._on_admit)
        self._wrap(edge, "_draft_round", self._on_draft_round)
        self._wrap(edge, "draft", self._on_draft)
        self._wrap(eng, "draft_speculative_slot", self._on_spec_slot)
        self._wrap(edge, "draft_speculative", self._on_spec)
        self._wrap(cloud, "verify", self._on_verify)
        self._wrap(cloud, "_verify_round", self._on_verify_round)

    @staticmethod
    def _wrap(obj, name, fn):
        orig = getattr(obj, name)
        setattr(obj, name, lambda *a, **kw: fn(orig, *a, **kw))

    def stream(self, b):
        """The committed tokens of row ``b``: position p at index p."""
        return self.prompt[b] + [int(t) for t in self.eng.out_tokens[b]]

    def _on_prefill(self, orig, prompts):
        self.prompt = {b: [int(t) for t in p]
                       for b, p in enumerate(np.asarray(prompts))}
        return orig(prompts)

    def _on_admit(self, orig, slot, prompt, seed, **kw):
        self.prompt[slot] = [int(t) for t in np.asarray(prompt)]
        return orig(slot, prompt, seed, **kw)

    def _on_draft_round(self, orig, *args):
        self._ys = orig(*args)
        return self._ys

    def _on_draft(self, orig, mask):
        ctx = {int(b): self.stream(int(b)) for b in np.nonzero(mask)[0]}
        out = orig(mask)
        for b, c in ctx.items():
            self._draft_row(c, b)
        return out

    def _on_spec_slot(self, orig, slot, rec):
        # the premise: every live draft accepted, then the edge's guess
        self._premise = self.stream(slot) + [
            int(t) for t in rec.drafts[:rec.n_live + 1]]
        return orig(slot, rec)

    def _on_spec(self, orig, slot, x_guess, pos_next, beta_next):
        out = orig(slot, x_guess, pos_next, beta_next)
        assert len(self._premise) == pos_next + 1
        self._draft_row(self._premise, slot)
        self.n_spec += 1
        return out

    def _draft_row(self, ctx, b):
        drafts = [int(t) for t in self._ys["token"][:-1, b]]
        logq = self._ys["q"][:, b].clamp_min(1e-30).log().numpy()
        self.rows["draft"].append((ctx + drafts, len(ctx) - 1, logq))

    def _on_verify(self, orig, mask, payloads, collect_p=False):
        self._mask = np.asarray(mask)
        return orig(mask, payloads, collect_p)

    def _on_verify_round(self, orig, tokens_in, pos, q_hat, live, keys):
        res, p, traj = orig(tokens_in, pos, q_hat, live, keys)
        toks = tokens_in.numpy()
        for b in np.nonzero(self._mask)[0]:
            ctx = self.stream(int(b))
            assert len(ctx) == int(pos[b]) + 1 and ctx[-1] == toks[b, 0]
            self.rows["target"].append(
                (ctx + [int(t) for t in toks[b, 1:]], len(ctx) - 1,
                 p[b].clamp_min(1e-30).log().numpy()))
            self.n_accept.append(int(res.n_accept[b]))
            self.rejected.append(bool(res.rejected[b]))
        return res, p, traj


@functools.lru_cache(maxsize=None)
def _forward_jit(jc):
    return jax.jit(functools.partial(jmodel.forward_logits, jc))


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _teacher_forced(side, rows, window, kv, draft, chunk=16):
    """The windowed teacher-forced log-softmax (T = 1) of each row's
    sequence, rows padded to a multiple of 64 tokens: the reference's
    ``forward_logits``; for int8 (its quantization moves logits by more
    than ORACLE_ATOL) the port's int8 cache sized never to wrap, the
    prompt prefilled and the rest in one extend, as serving computes
    it."""
    jc, jp, m = _bridged(window, draft=draft, seed=2 if draft else 1,
                         **({"n_layers": 2} if draft else {}),
                         **({"kv_cache_dtype": kv} if kv != "compute"
                            else {}))
    Lp = -(-max(len(s) for s, _, _ in rows) // 64) * 64
    out = []
    for i in range(0, len(rows), chunk):
        toks = np.zeros((chunk, Lp), np.int64)
        for j, (s, _, _) in enumerate(rows[i:i + chunk]):
            toks[j, :len(s)] = s
        if kv == "compute":
            lg = np.asarray(_forward_jit(jc)(
                jp, jnp.asarray(toks.astype(np.int32))))
        else:
            P = PAST - 1
            t = torch.from_numpy(toks)
            _, c = tmodel.prefill(m, t[:, :P], cache_len=Lp, spare=Lp)
            lg, _, _ = tmodel.extend_step(m, t[:, P:], c,
                                          torch.full((chunk,), P))
            lg = np.concatenate([np.zeros((chunk, P, lg.shape[-1]),
                                          np.float32), lg.numpy()], 1)
        out.append(_log_softmax(lg))
    return np.concatenate(out)


def _worst(rec, window_target, window_draft, kv):
    """max |log q - teacher-forced| over the draft rows and max |log p -
    teacher-forced| over the target rows."""
    worst = {}
    for side, window, draft in (("target", window_target, False),
                                ("draft", window_draft, True)):
        rows = rec.rows[side]
        ref = _teacher_forced(side, rows, window, kv, draft)
        worst[side] = max(
            float(np.abs(d - ref[i, st:st + d.shape[0]]).max())
            for i, (_, st, d) in enumerate(rows))
    return worst


def _serve_past_the_wrap(window_target, window_draft, path, method,
                         budget, kv="compute"):
    """One run past the wrap: ``path`` fixed (``EdgeCloudEngine.run``, 2
    rows of PAST-token prompts, 4 rounds), or a lockstep / pipelined
    (with speculation) trace of PAST_TRACE over 2 slots.  The draft has
    2 layers, so that a key read wrongly in layer 0 reaches a cache write
    in layer 1.  Returns the recorder."""
    over = {} if kv == "compute" else {"kv_cache_dtype": kv}
    _, _, tm = _bridged(window_target, seed=1, **over)
    _, _, dm = _bridged(window_draft, draft=True, seed=2, n_layers=2,
                        **over)
    eng = EdgeCloudEngine(dm.cfg, dm, tm.cfg, tm, MethodConfig(**method),
                          EngineConfig(L_max=L_MAX, bit_budget=budget,
                                       collect_theory=True),
                          seed=0, device="cpu")
    rec = _Rounds(eng)
    if path == "fixed":
        prompts = np.random.default_rng(0).integers(0, 512, (2, PAST))
        eng.run(prompts, 4)
    else:
        rep = tserve.ServeSession(eng, tserve.ServeConfig(
            max_batch=2, cache_len=PAST_CACHE, t_slm_s=0.01, t_llm_s=0.02,
            pipeline=path)).run_trace(
                tserve.poisson_trace(tserve.TraceConfig(**PAST_TRACE)))
        assert rep.n_finished == PAST_TRACE["n_requests"]
    for model, cache in ((tm, eng.tcache), (dm, eng.dcache)):
        if tattn.window(model.cfg):
            R = tattn.window(model.cfg) + tengine.ring_spare(L_MAX)
            assert cache[0]["k"].shape[1] == R and PAST > 2 * R
    return rec


@pytest.mark.parametrize("window_target,window_draft,kv",
                         [(64, 0, "compute"), (0, 64, "compute"),
                          (32, 32, "compute"), (32, 32, "int8")])
def test_engine_serves_past_the_wrap(window_target, window_draft, kv):
    """A sliding-window target, draft or both, served past two wraps of
    the ring: fixed batch (rounds that reject and rounds that accept),
    lockstep slots (reject), pipelined slots with speculation (both).
    Every committed row's draft log q and target log p equal the
    teacher-forced log-softmax of the same tokens within TOL (int8: the
    int8 recompute on a cache that never wraps)."""
    runs = [("fixed", *REJECT), ("fixed", *ACCEPT), ("lockstep", *REJECT),
            ("pipelined", *REJECT), ("pipelined", *ACCEPT)]
    for path, method, budget in runs:
        rec = _serve_past_the_wrap(window_target, window_draft, path, method,
                                   budget, kv)
        assert rec.rows["draft"] and rec.rows["target"]
        if method is ACCEPT[0]:
            assert max(rec.n_accept) > 0          # rounds accept
        else:
            assert any(rec.rejected)
        if path == "pipelined":
            assert rec.n_spec > 0
        worst = _worst(rec, window_target, window_draft, kv)
        assert max(worst.values()) <= TOL[kv], (path, method, worst)


def test_one_slot_short_of_the_spare_loses_keys_under_speculation(
        monkeypatch):
    """With the ring one slot shorter than ``ring_spare`` (2 L_max - 1),
    a pipelined trace with speculation drafts from a lost key: after a
    speculative round of L_max live drafts, a corrective draft that
    follows a miss at T = 0 reads the speculative round's last key as a
    key W back (the draft's q leaves the recompute by far more than
    ORACLE_ATOL); the lockstep paths and the cloud, which write at most
    L_max past their next query, stay within it."""
    assert ring_spare(L_MAX) == 2 * L_MAX
    monkeypatch.setattr(tengine, "ring_spare", lambda L: 2 * L - 1)
    rec = _serve_past_the_wrap(32, 32, "pipelined", *ACCEPT)
    worst = _worst(rec, 32, 32, "compute")
    assert worst["draft"] > 100 * ORACLE_ATOL, worst
    assert worst["target"] <= ORACLE_ATOL, worst
    rec = _serve_past_the_wrap(32, 32, "lockstep", *ACCEPT)
    assert max(_worst(rec, 32, 32, "compute").values()) <= ORACLE_ATOL


def test_tcp_serves_past_the_wrap():
    """``CloudServer`` verifies for a sliding-window pair past the wrap
    (its ring's spare from the HELLO's L_max): a pipelined trace through
    ``EdgeClient`` gives the in-process simulator's streams, whose rounds
    equal the teacher-forced recompute."""
    _, _, tm = _bridged(32, seed=1)
    _, _, dm = _bridged(32, draft=True, seed=2, n_layers=2)
    method, ecfg = MethodConfig(**ACCEPT[0]), EngineConfig(
        L_max=L_MAX, bit_budget=ACCEPT[1], collect_theory=True)
    cfg = dict(max_batch=2, cache_len=PAST_CACHE, pipeline="pipelined")
    trace = tserve.TraceConfig(**PAST_TRACE)
    eng = EdgeCloudEngine(dm.cfg, dm, tm.cfg, tm, method, ecfg, seed=0,
                          device="cpu")
    rec = _Rounds(eng)
    sim = tserve.ServeSession(eng, tserve.ServeConfig(
        t_slm_s=0.01, t_llm_s=0.02, **cfg)).run_trace(
            tserve.poisson_trace(trace))
    assert max(_worst(rec, 32, 32, "compute").values()) <= ORACLE_ATOL
    server = tserve.CloudServer(device="cpu",
                                build_target=lambda *a: tm).start()
    try:
        client = tserve.EdgeClient(
            dm.cfg, dm, method, ecfg, tserve.ServeConfig(**cfg), arch=ARCH,
            smoke=True, host=server.host, port=server.port, seed=0,
            io_timeout_s=60.0, device="cpu")
        with client:
            rep = client.run_trace(tserve.poisson_trace(trace))
    finally:
        server.stop()
    assert rep.streams() == {r.rid: tuple(r.tokens) for r in sim.requests}


def test_trace_on_a_ring_that_cannot_wrap_matches_reference():
    """cache_len == W: the ring never wraps, and the port serves the
    reference's streams and summary."""
    (jt, jtp, tm), (jd, jdp, dm) = _bridged(32, seed=1), \
        _bridged(32, draft=True, seed=2)
    ref = RefEngine(jd, jdp, jt, jtp, RefMethodConfig(**CSQS),
                    RefEngineConfig(L_max=3), seed=0)
    port = _engine(32, 32)
    cfg = dict(max_batch=2, cache_len=32, t_slm_s=0.01, t_llm_s=0.02)
    reps = [srv.ServeSession(eng, srv.ServeConfig(**cfg)).run_trace(
        srv.poisson_trace(srv.TraceConfig(**TRACE)))
        for srv, eng in ((jserve, ref), (tserve, port))]
    streams = [{r.rid: tuple(r.tokens) for r in rep.requests}
               for rep in reps]
    assert streams[0] == streams[1]
    assert reps[0].summary() == reps[1].summary()
    assert reps[1].n_finished == TRACE["n_requests"]
