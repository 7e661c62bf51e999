"""The port's SQS kernel wrappers against the reference's: on a CPU
tensor the wrappers run the plain twins, which must give the reference
Pallas kernel's (interpreted) and its jnp oracle's q̂, support and K
exactly, over the sweep of tests/test_kernels.py (V <= 50257).  The
Hopper kernels themselves run only on a card: the ``cuda`` tests hold
them against the twins there and skip elsewhere."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sqs_fused as jk  # noqa: E402
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


def test_unpadded_vs_padded_vocab():
    logits = _logits(5, 2, 1003)           # not a multiple of 128
    beta = torch.full((2,), 1e-3)
    t = tops.sqs_threshold(torch.from_numpy(logits), beta, ell=100)
    assert t.q_hat.shape == (2, 1003)
    _same(jops.sqs_threshold(jnp.asarray(logits), jnp.asarray(beta.numpy()),
                             ell=100), t)


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
    # near-uniform rows with beta <= 0: K = V, the select sweeps the
    # cluster before it compacts
    near = tops.pad_logits(torch.randn((B, V), generator=gen,
                                       device=cuda_device) * 0.01)[0]
    low = torch.full((B, 2), -1.0, device=cuda_device)
    b, m, s = tk.sqs_fused(near, low, inv_temp=1.0, ell=100)
    rb, rm, rs = tref.sqs_fused_ref(near, low, inv_temp=1.0, ell=100)
    assert (b.sum(-1) == 100).all() and torch.equal(m, rm)
    assert torch.equal(s[:, 1], rs[:, 1]) and torch.equal(s[:, 2], rs[:, 2])
