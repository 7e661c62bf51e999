"""The port's SQS kernel wrappers against the reference's: on a CPU
tensor the wrappers run the plain twins, which must give the reference
Pallas kernel's (interpreted) and its jnp oracle's q̂, support and K
exactly, over the sweep of tests/test_kernels.py (V <= 50257).  On a
vocabulary padded to a multiple of 128 the fused C-SQS path keeps the
padded lanes out of its support at every β, as the reference's jnp rule
``repro.core.sqs.sparsify_threshold`` and the port's plain path do; the
reference's Pallas path counts them in K at β <= 0 (ROADMAP Queue 3
item 13).  The Hopper kernels themselves run only on a card: the
``cuda`` tests hold them against the twins there and skip elsewhere."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bits as jbits  # noqa: E402
from repro.core import sqs as jsqs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sqs_fused as jk  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core import bits as tbits  # noqa: E402
from repro_torch.core import sqs as tsqs  # noqa: E402
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,  # noqa: E402
                                     MethodConfig, summarize)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import sqs_fused as tk  # noqa: E402


def _logits(seed, B, V, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, V)) * scale).astype(np.float32)


def _same(j, t, ell=100):
    np.testing.assert_array_equal(np.asarray(j.q_hat), t.q_hat.numpy())
    np.testing.assert_array_equal(np.asarray(j.mask), t.mask.numpy())
    np.testing.assert_array_equal(np.asarray(j.K), t.K.numpy())
    np.testing.assert_allclose(np.asarray(j.dropped), t.dropped.numpy(),
                               atol=1e-6)
    np.testing.assert_array_equal(
        np.round(t.q_hat.numpy() * ell).sum(-1), ell)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the Hopper kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,V", [(1, 128), (4, 1000), (2, 4096),
                                 (3, 50257)])
@pytest.mark.parametrize("temp", [0.5, 1.0])
def test_sqs_threshold_twin_vs_reference(B, V, temp):
    logits = _logits(B * V, B, V)
    beta = np.full((B,), 2e-3, np.float32)
    t = tops.sqs_threshold(torch.from_numpy(logits), torch.from_numpy(beta),
                           temperature=temp, ell=100)
    for use_ref in (False, True):
        _same(jops.sqs_threshold(jnp.asarray(logits), jnp.asarray(beta),
                                 temperature=temp, ell=100,
                                 use_ref=use_ref), t)


@pytest.mark.parametrize("V,K,ell", [(1000, 8, 100), (1000, 64, 100),
                                     (4096, 16, 50), (50257, 256, 1000),
                                     (512, 1, 100)])
def test_sqs_topk_twin_vs_reference(V, K, ell):
    logits = _logits(V + K, 3, V)
    t = tops.sqs_topk(torch.from_numpy(logits), K, ell=ell)
    assert (t.K.numpy() == K).all()
    for use_ref in (False, True):
        _same(jops.sqs_topk(jnp.asarray(logits), K, ell=ell,
                            use_ref=use_ref), t, ell)


@pytest.mark.parametrize("V,K,temp,scale", [
    (1000, 1, 1.0, 3.0), (1000, 10, 1.0, 3.0), (1000, 999, 1.0, 3.0),
    (4096, 64, 1.0, 3.0), (4096, 16, 0.2, 8.0), (4096, 16, 0.05, 3.0),
    (512, 64, 0.05, 8.0)])
def test_topk_twin_brackets_kth_largest(V, K, temp, scale):
    """lo is the exact K-th largest probability and hi the float after it,
    also at low temperature, where the K-th value of some rows lies below
    max q * 2^-40 (the reference's bisection floor) or, at T 0.05,
    underflows to 0."""
    lp = torch.from_numpy(_logits(K, 4, V, scale))
    lp = tops.pad_logits(lp)[0]
    tau = tk.topk_threshold(lp, K, inv_temp=1.0 / temp)
    q = tref.softmax_padded(lp, 1.0 / temp)
    kth = tref.kth_largest_ref(q, K)
    assert torch.equal(tau[:, 0], kth)
    assert torch.equal(tau[:, 1], torch.nextafter(kth, torch.ones_like(kth)))
    assert ((q >= tau[:, 0:1]).sum(-1) >= K).all()
    assert ((q >= tau[:, 1:2]).sum(-1) < K).all()
    if temp < 1.0:                        # rows past the reference's floor
        assert (kth < q.amax(-1) * 2.0 ** -40).any()
        assert (kth == 0).any() or temp > 0.05


# the reference runs its jnp rule jitted inside its engine
_jnp_threshold = jax.jit(jsqs.sparsify_threshold, static_argnums=2)


def _csqs_bits(r, V, ell=100):
    """The engine's C-SQS bits of one result: eq. (1)'s token bits and
    the gap-coded bits (``EdgeDraftEngine._sqs_bits``)."""
    K = torch.as_tensor(np.array(r.K)).float()
    mask = torch.as_tensor(np.array(r.mask))
    return np.stack([
        tbits.token_bits(V, K, ell, adaptive=True).numpy(),
        (tbits.gap_code_subset_bits(mask)
         + tbits.payload_bits(K, ell)).numpy()])


@pytest.mark.parametrize("beta", [1e-3, 0.0, -0.01])
def test_unpadded_vs_padded_vocab(beta):
    """V 1003, padded to 1024: the fused C-SQS path's q̂, support, K,
    dropped mass and bits equal the port's plain path and the
    reference's jnp rule at every β (K = V at β <= 0), and the
    reference's Pallas path at β > 0; its counts hold Σb = ℓ and b = 0
    from V on."""
    V = 1003                               # not a multiple of 128
    logits = _logits(5, 2, V)
    b = np.full((2,), beta, np.float32)
    t = tops.sqs_threshold(torch.from_numpy(logits), torch.from_numpy(b),
                           ell=100)
    assert t.q_hat.shape == (2, V)
    q = tsqs.softmax_temp(torch.from_numpy(logits), 1.0)
    plain = tsqs.sparsify_threshold(q, torch.from_numpy(b), 100)
    rule = _jnp_threshold(jnp.asarray(q.numpy()), jnp.asarray(b), 100)
    for want in (plain, rule):
        _same(want, t)
        np.testing.assert_array_equal(_csqs_bits(want, V),
                                      _csqs_bits(t, V))
    np.testing.assert_allclose(
        np.asarray(jbits.token_bits(V, rule.K.astype(jnp.float32), 100,
                                    adaptive=True)),
        _csqs_bits(t, V)[0], rtol=1e-6)
    pallas = jops.sqs_threshold(jnp.asarray(logits), jnp.asarray(b),
                                ell=100)
    if beta > 0:
        _same(pallas, t)
    else:
        assert (t.K.numpy() == V).all()
        # the reference's Pallas path keeps the padded lanes
        assert (np.asarray(pallas.K) == tk.pad_vocab(V)).all()
    lp = tops.pad_logits(torch.from_numpy(logits))[0]
    b2 = torch.from_numpy(np.stack([b, b], -1))
    cb, cm, cs = tk.sqs_fused(lp, b2, inv_temp=1.0, ell=100, V=V)
    assert not cm[:, V:].any() and not cb[:, V:].any()
    assert (cb.sum(-1) == 100).all()
    assert torch.equal(cs[:, 1].to(torch.int32), t.K)


def test_topk_padded_vocab_low_temperature():
    """K-SQS on V 1003 at T 0.05, where some rows have fewer than K
    nonzero probabilities: the index-ordered trim of the ties at 0 keeps
    lanes below V only (V >= K), K stays K, Σb = ℓ, and the fused path
    equals the port's plain top-K rule."""
    V, K, temp = 1003, 64, 0.05
    logits = torch.from_numpy(_logits(11, 4, V, scale=8.0))
    q = tsqs.softmax_temp(logits, temp)
    assert ((q > 0).sum(-1) < K).any()
    t = tops.sqs_topk(logits, K, temperature=temp, ell=100)
    _same(tsqs.sparsify_topk(q, K, 100), t)
    assert (t.K == K).all()
    it = 1.0 / max(temp, 1e-4)
    lp = tops.pad_logits(logits)[0]
    tau = tk.topk_threshold(lp, K, inv_temp=it)
    cb, cm, cs = tk.sqs_fused(lp, tau, inv_temp=it, ell=100, exact_k=K,
                              V=V)
    assert (cm.sum(-1) == K).all() and not cm[:, V:].any()
    assert not cb[:, V:].any() and (cb.sum(-1) == 100).all()


def test_engine_csqs_padded_vocab_negative_beta():
    """A C-SQS engine on a vocabulary that is not a multiple of 128 with
    β0 < 0 (every token in the support, and β only falls): the fused
    path gives the plain path's mean K (V, not the padded width), bits,
    wire sizes and streams.  (The payload's β trajectory may differ in
    float32 ulps: the kernel's dropped mass is 1 - Σq in its own sum
    order.)"""
    cfg = dataclasses.replace(
        configs.smoke_variant(configs.get_config("qwen2.5-3b")), vocab=1003)
    dcfg = configs.draft_variant(cfg, 2)
    tm = bridge.seeded_model(cfg, 1, device="cpu")
    dm = bridge.seeded_model(dcfg, 2, device="cpu")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (2, 8))
    runs = []
    for use_kernels in (True, False):
        eng = EdgeCloudEngine(dcfg, dm, cfg, tm, MethodConfig(
            "csqs", alpha=5e-3, eta=5e-2, beta0=-0.01,
            use_kernels=use_kernels), EngineConfig(L_max=3), seed=0,
            device="cpu")
        runs.append(eng.run(prompts, 3))
    (kr, kt), (pr, pt) = runs
    assert kt == pt, "token streams differ"
    ks, ps = summarize(kr), summarize(pr)
    assert ks["mean_K"] == ps["mean_K"] == cfg.vocab
    for key in ("bits_per_batch", "gap_bits_per_batch",
                "wire_bits_per_batch"):
        assert ks[key] == ps[key], key


@pytest.mark.parametrize("trial", range(8))
def test_select_n_semantics(trial):
    """The twin's rank select makes the reference kernel's in-VMEM
    bisection select: exactly n of the eligible entries, the largest,
    ties to the earliest index."""
    rng = np.random.default_rng(trial)
    Vp = 256
    v = rng.uniform(-0.5, 0.5, (1, Vp)).astype(np.float32)
    if trial % 2:
        v = np.round(v * 8) / 8                  # many exact ties
    elig = rng.random((1, Vp)) < 0.4
    n = float(rng.integers(0, elig.sum() + 1))
    want = np.asarray(jk._select_n(jnp.asarray(v), jnp.asarray(elig),
                                   jnp.full((1, 1), n, jnp.float32)))
    got = tref.select_n_ref(torch.from_numpy(v), torch.from_numpy(elig),
                            torch.full((1, 1), n)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == n and not (got & ~elig).any()


def test_cpu_tensor_takes_the_twin_and_never_launches():
    before = dict(tk.LAUNCHES)
    lp = tops.pad_logits(torch.from_numpy(_logits(1, 2, 300)))[0]
    tk.sqs_fused(lp, torch.zeros((2, 2)), inv_temp=1.0, ell=100)
    tk.topk_threshold(lp, 4, inv_temp=1.0)
    assert tk.LAUNCHES == before
    with pytest.raises(ValueError):
        tk.sqs_fused(lp.to("meta"), torch.zeros((2, 2), device="meta"),
                     inv_temp=1.0, ell=100)


@pytest.mark.cuda
@pytest.mark.parametrize("B,V", [(3, 50257), (4, 151936)])
def test_kernels_vs_twin_on_card(cuda_device, B, V):
    gen = torch.Generator(device=cuda_device).manual_seed(B * V)
    logits = torch.randn((B, V), generator=gen, device=cuda_device) * 3
    lp = tops.pad_logits(logits)[0]
    beta2 = torch.full((B, 2), 2e-3, device=cuda_device)
    for (b, m, s), (rb, rm, rs) in [
            (tk.sqs_fused(lp, beta2, inv_temp=1.0, ell=100),
             tref.sqs_fused_ref(lp, beta2, inv_temp=1.0, ell=100))]:
        assert (b.sum(-1) == 100).all()
        assert torch.equal(m, rm) and torch.equal(s[:, 1], rs[:, 1])
        assert torch.equal(s[:, 2], rs[:, 2]) and torch.equal(s[:, 3], rs[:, 3])
        assert (s[:, 0] - rs[:, 0]).abs().max() <= 1e-6
    tau = tk.topk_threshold(lp, 64, inv_temp=1.0)
    r = tops.sqs_topk(logits, 64)
    assert (r.K == 64).all() and (tau[:, 0] <= tau[:, 1]).all()
    # K-SQS through the kernels: K == exact_k, sum b == ell
    b, m, s = tk.sqs_fused(lp, tau, inv_temp=1.0, ell=100, exact_k=64)
    assert (s[:, 1] == 64).all() and (m.sum(-1) == 64).all()
    assert (b.sum(-1) == 100).all()
    # near-uniform rows with beta <= 0: K = V (no padded lane), the
    # select sweeps the cluster before it compacts
    near = tops.pad_logits(torch.randn((B, V), generator=gen,
                                       device=cuda_device) * 0.01)[0]
    low = torch.full((B, 2), -1.0, device=cuda_device)
    b, m, s = tk.sqs_fused(near, low, inv_temp=1.0, ell=100, V=V)
    rb, rm, rs = tref.sqs_fused_ref(near, low, inv_temp=1.0, ell=100, V=V)
    assert (b.sum(-1) == 100).all() and torch.equal(m, rm)
    assert torch.equal(s[:, 1], rs[:, 1]) and torch.equal(s[:, 2], rs[:, 2])
    assert (s[:, 1] == V).all() and not b[:, V:].any()
