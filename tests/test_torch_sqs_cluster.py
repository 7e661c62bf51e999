"""The cluster design of the Hopper SQS kernels, emulated on the CPU.

``csrc/sqs_fused.cu`` splits a row over a thread-block cluster
(``plan_cluster``), sums in a fixed order (per thread, per block, then
over ranks) and cuts its two bisections (the top-K bracket and the +-1
select) into multi-level sweeps over the midpoint tree plus a compaction
into one block.  The kernels run only on a card; here a plain numpy
emulation of the same steps is held against the sequential loops: the
port's twins (``ref.topk_threshold_ref``, ``ref.select_n_ref``) and the
reference's Pallas kernels (interpreted), bit for bit, and the emulated
kernel's integer outputs against the reference's at the seeds of
``tests/test_torch_kernels.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sqs_fused as jk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import sqs_fused as tk  # noqa: E402

F = np.float32
NEG_V = F(-2.0)
HALF = F(0.5)
NT, TILE = tk.NT, 4 * tk.NT
M = (1 << tk.LEVELS) - 1                 # midpoints per sweep


# ----------------------------------------------------------------------
# the cut bisection, as the kernel runs it
# ----------------------------------------------------------------------
def thresholds(lo, hi):
    """thr[1..M]: the next LEVELS levels of the loop's midpoint tree from
    (lo, hi), in order (thr[2^(LEVELS-1)] is the next mid)."""
    thr = np.zeros(M + 1, F)

    def node(p, d, lo, hi):
        mid = HALF * (lo + hi)
        thr[p] = mid
        if d:
            node(p - d, d // 2, lo, mid)
            node(p + d, d // 2, mid, hi)
    node(1 << (tk.LEVELS - 1), 1 << (tk.LEVELS - 2), lo, hi)
    return thr


def bins(v, lo, hi, thr):
    inner = 1 + np.searchsorted(thr[1:], v, side="right")
    return np.where(v < lo, 0, np.where(v >= hi, M + 2, inner))


def suffix(hist):
    return np.concatenate([np.cumsum(hist[::-1])[::-1], [0]])


class Bis:
    def __init__(self, lo, hi):
        self.lo, self.hi = F(lo), F(hi)
        self.done = self.cnt_lo = self.cnt_hi = 0
        self.lo_bin = self.hi_bin = 0

    def replay(self, steps, thr, sfx, n, above=0, floor_v=F(0), n_floor=0):
        p, d = 1 << (tk.LEVELS - 1), 1 << (tk.LEVELS - 2)
        for _ in range(steps):
            mid = thr[p]
            cnt = int(sfx[p + 1]) + above + (n_floor if mid <= floor_v
                                             else 0)
            if cnt >= n:
                self.lo, self.cnt_lo, self.lo_bin = mid, cnt, p + 1
                p += d
            else:
                self.hi, self.cnt_hi, self.hi_bin = mid, cnt, p + 1
                p -= d
            d //= 2
        self.done += steps


def cluster_sweep(bis, v, iters, n, path):
    """One sweep over every value: bins of the next levels, replay."""
    thr = thresholds(bis.lo, bis.hi)
    hist = np.bincount(bins(v, bis.lo, bis.hi, thr), minlength=M + 3)
    sfx = suffix(hist)
    bis.cnt_lo, bis.cnt_hi = int(sfx[1]), int(sfx[M + 2])
    bis.lo_bin, bis.hi_bin = 1, M + 2
    bis.replay(min(tk.LEVELS, iters - bis.done), thr, sfx, n)
    path.append("sweep")


def local_finish(bis, buf, iters, n, above, floor_v=F(0), n_floor=0,
                 path=None):
    """Block 0 alone over its buffer: one warp runs the loop itself up to
    WARP_MAX values, block sweeps take larger buffers."""
    if buf.size <= tk.WARP_MAX:
        for _ in range(bis.done, iters):
            mid = HALF * (bis.lo + bis.hi)
            cnt = above + (n_floor if mid <= floor_v else 0) \
                + int((buf >= mid).sum())
            if cnt >= n:
                bis.lo = mid
            else:
                bis.hi = mid
        bis.done = iters
        path.append("warp")
        return
    while bis.done < iters:
        thr = thresholds(bis.lo, bis.hi)
        hist = np.bincount(bins(buf, bis.lo, bis.hi, thr), minlength=M + 3)
        bis.replay(min(tk.LEVELS, iters - bis.done), thr, suffix(hist), n,
                   above, floor_v, n_floor)
        path.append("local")


def in_range(v, lo, hi):
    return ~(v < lo) & ~(v >= hi)


def topk_cut(q, K, iters, cap=tk.CAP):
    """topk_threshold_kernel's bracket of one row q; returns (lo, hi,
    path)."""
    q = q.astype(F)
    bis, path = Bis(0.0, q.max()), []
    while bis.done < iters:
        cluster_sweep(bis, q, iters, K, path)
        nb = bis.cnt_lo - bis.cnt_hi
        if bis.done < iters and nb <= cap:
            buf = q[in_range(q, bis.lo, bis.hi)]
            assert buf.size == nb
            path.append(f"compact {nb}")
            local_finish(bis, buf, iters, K, bis.cnt_hi, path=path)
            break
    return bis.lo, bis.hi, path


def select_cut(v, elig, n, cap=tk.CAP):
    """sqs_fused_kernel's +-1 select of one row: the n largest eligible
    keys, ties to the earliest index; returns (selection, path)."""
    iters = tk.BISECT_ITERS
    vv = np.where(elig, v, NEG_V).astype(F)
    n_elig = int(elig.sum())
    bis, path = Bis(NEG_V, vv.max() + F(1e-6)), []
    buf = None
    if n_elig <= cap:                       # compact the eligible at once
        buf, above = vv[elig], 0
        path.append(f"compact {n_elig}")
        local_finish(bis, buf, iters, n, 0, NEG_V, vv.size - n_elig, path)
    else:
        # steps with mid <= the least eligible key need no sweep
        kmin = v[elig].min()
        while bis.done < iters - 1:
            mid = HALF * (bis.lo + bis.hi)
            cnt = n_elig + (vv.size - n_elig if mid <= NEG_V else 0)
            if not mid <= kmin or cnt < n:
                break
            bis.lo = mid
            bis.done += 1
        while bis.done < iters:
            cluster_sweep(bis, vv, iters, n, path)
            nb = bis.cnt_lo - bis.cnt_hi
            if bis.done < iters and nb <= cap:
                buf, above = vv[in_range(vv, bis.lo, bis.hi)], bis.cnt_hi
                path.append(f"compact {nb}")
                local_finish(bis, buf, iters, n, above, path=path)
                break
    lo, hi = bis.lo, bis.hi
    if buf is not None:                     # block 0's verdict
        c_hi = above + int(((buf != NEG_V) & (buf >= hi)).sum())
    else:                                   # every step over the cluster
        c_hi = bis.cnt_hi
    sel = elig & (vv >= hi)
    ties = elig & ~sel & (vv >= lo)
    sel |= ties & (np.cumsum(ties) <= n - c_hi)
    return sel, path


# ----------------------------------------------------------------------
# the cut bisections against the sequential loop
# ----------------------------------------------------------------------
def _row(kind, V, seed):
    rng = np.random.default_rng(seed)
    if kind == "logits":
        x = rng.standard_normal(V) * 3
    elif kind == "tied":                  # runs of equal probabilities
        x = np.round(rng.standard_normal(V) * 2) / 2
    elif kind == "equal":
        x = np.zeros(V)
    elif kind == "plateau":               # one peak over V - 1 equal values
        x = np.zeros(V)
        x[0] = 5.0
    else:                                 # near-uniform
        x = rng.standard_normal(V) * 0.01
    e = np.exp(x - x.max())
    return (e / e.sum()).astype(F)


_pallas_topk = jax.jit(jk.topk_threshold_call, static_argnames=("K", "iters"))


def _loop_bracket(q, K, iters):
    twin = tref.topk_threshold_ref(torch.from_numpy(q)[None], K,
                                   iters)[0].numpy()
    pallas = np.asarray(_pallas_topk(jnp.asarray(q)[None], K=K,
                                     iters=iters))[0]
    np.testing.assert_array_equal(twin, pallas)
    return twin


@pytest.mark.parametrize("kind,V,K", [
    ("logits", 4096, 1), ("logits", 4096, 4096), ("logits", 4096, 64),
    ("tied", 4096, 700), ("equal", 1024, 64), ("plateau", 4096, 64),
    ("near", 30000, 64)])
@pytest.mark.parametrize("iters", [1, 7, 8, 9, 40])
def test_topk_cut_equals_loop(kind, V, K, iters):
    q = _row(kind, V, V + K)
    if kind == "tied":                    # K falls inside a run of ties
        s = np.sort(q)[::-1]
        assert s[K - 1] == s[K] or s[K - 1] == s[K - 2]
    want = _loop_bracket(q, K, iters)
    for cap in (tk.CAP, 16):              # 16: the compaction rarely fits
        lo, hi, path = topk_cut(q, K, iters, cap)
        np.testing.assert_array_equal(np.array([lo, hi]), want, err_msg=path)
    if kind == "plateau":      # K-th value inside the plateau: never fits
        assert topk_cut(q, K, iters, 16)[2] == \
            ["sweep"] * -(-iters // tk.LEVELS)


_pallas_select = jax.jit(jk._select_n)     # one compile per row length


def _loop_select(v, elig, n):
    twin = tref.select_n_ref(torch.from_numpy(v)[None],
                             torch.from_numpy(elig)[None],
                             torch.full((1, 1), n)).numpy()[0]
    pallas = np.asarray(_pallas_select(jnp.asarray(v)[None],
                                       jnp.asarray(elig)[None],
                                       jnp.full((1, 1), n, jnp.float32)))[0]
    np.testing.assert_array_equal(twin, pallas)
    return twin


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("V,frac,tied", [(512, 0.3, False),
                                         (512, 0.3, True),
                                         (4096, 1.0, True),
                                         (20000, 1.0, False)])
@pytest.mark.parametrize("cap", [tk.CAP, 64])
def test_select_cut_equals_loop(sign, V, frac, tied, cap):
    """delta > 0 (sign 1: the largest zeta among b > 0) and delta < 0
    (sign -1: the largest -zeta), with ties in zeta; cap 64 forces the
    cluster sweeps before the compaction (the near-uniform K = V case)."""
    rng = np.random.default_rng(V + int(tied) + 7 * sign)
    zeta = rng.uniform(-0.5, 0.5, V)
    if tied:
        zeta = np.round(zeta * 16) / 16
    v = (sign * zeta).astype(F)
    elig = rng.random(V) < frac
    for n in (1, 2, int(elig.sum()) // 3, int(elig.sum()) // 2):
        want = _loop_select(v, elig, n)
        got, path = select_cut(v, elig, n, cap)
        np.testing.assert_array_equal(got, want, err_msg=str(path))
        assert got.sum() == n
        assert (path[0] == "sweep") == (int(elig.sum()) > cap)


def test_select_all_equal_never_fits():
    """Every key equal: no sweep narrows [lo, hi), so the steps left after
    the mids below the keys all run over the cluster and the ties come from
    the last histogram."""
    V = 3000
    v = np.full(V, F(0.25))
    elig = np.ones(V, bool)
    for n in (1, 1000):
        got, path = select_cut(v, elig, n, cap=64)
        assert path and set(path) == {"sweep"}
        np.testing.assert_array_equal(got, _loop_select(v, elig, n))


# ----------------------------------------------------------------------
# the cluster plan
# ----------------------------------------------------------------------
@pytest.mark.parametrize("Vp", [128, 1024, 4096, 50304, 151936, 152064,
                                20608, 327680])
def test_plan_cluster(Vp):
    C, L = tk.plan_cluster(Vp)
    assert C & (C - 1) == 0 and 1 <= C <= tk.CLUSTER_MAX
    assert L % tk.LANE == 0 and L <= tk.SLICE_MAX
    # the slices cover [0, Vp) once, in index order, none empty
    starts = [r * L for r in range(C)]
    ends = [min((r + 1) * L, Vp) for r in range(C)]
    assert starts[0] == 0 and ends[-1] == Vp
    assert all(e > s for s, e in zip(starts, ends))
    assert all(ends[r] == starts[r + 1] for r in range(C - 1))
    assert tk.smem_bytes(C, L) + tk.SMEM_STATIC <= tk.MAX_SMEM
    # one C for both kernels: the plan takes Vp alone
    assert tk.plan_cluster(Vp) == (C, L)
    if C > 1:                             # and no smaller cluster holds it
        assert -(-Vp // (C // 2)) > tk.SLICE_MAX


def test_plan_main_path():
    assert tk.plan_cluster(151936) == (8, 19072)
    with pytest.raises(ValueError):
        tk.plan_cluster(tk.CLUSTER_MAX * tk.SLICE_MAX + tk.LANE)


# ----------------------------------------------------------------------
# the whole kernel: rank-ordered cluster sums at C of the plan
# ----------------------------------------------------------------------
def block_sum(vals):
    """A block's f32 sum of its slice as the kernel takes it: per thread
    over its tiles in order (thread t owns [4t, 4t + 4) of each 4096-entry
    tile), then warp butterflies, then warp 0 over the warp sums."""
    n_tiles = -(-vals.size // TILE)
    a = np.zeros(n_tiles * TILE, F)
    a[:vals.size] = vals
    a = a.reshape(n_tiles, NT, 4)
    acc = np.zeros(NT, F)
    for t in range(n_tiles):
        for j in range(4):
            acc = acc + a[t, :, j]

    def butterfly(x):                      # (..., 32) -> lane 0
        lanes = np.arange(32)
        for o in (16, 8, 4, 2, 1):
            x = x + x[..., lanes ^ o]
        return x[..., 0]
    return butterfly(butterfly(acc.reshape(NT // 32, 32)))


def cluster_sum(vals, L):
    s = None
    for r in range(0, vals.size, L):
        p = block_sum(vals[r:r + L])
        s = p if s is None else F(s + p)
    return s


def emulated_kernel(lp, thr, it, ell, exact_k, C, L):
    """sqs_fused_kernel on one padded row: cluster sums in rank order, the
    K-SQS trim, the rounding and the cut select."""
    x = lp * F(it)
    m = x.max()
    e = np.exp(x - m)
    s = cluster_sum(e, L)
    q = e / s
    if exact_k > 0:
        cand = q >= thr
        mask = cand & (np.cumsum(cand) <= exact_k)
    else:
        mask = (q >= thr) | (x >= m)
    sm = cluster_sum(np.where(mask, q, F(0)), L)
    qt = np.where(mask, q / sm, F(0))
    b = np.where(mask, np.floor(F(ell) * qt + HALF), F(0)).astype(F)
    delta = int(b.sum()) - ell
    zeta = (b - F(ell) * qt).astype(F)
    if delta > 0:
        sel, _ = select_cut(zeta, mask & (b > 0), delta)
        b = b - sel
    elif delta < 0:
        sel, _ = select_cut(-zeta, mask, -delta)
        b = b + sel
    return b.astype(np.int32), mask, int(mask.sum()), q


def _logits(seed, B, V, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, V)) * scale).astype(np.float32)


def _pad(x):
    Vp = tk.pad_vocab(x.shape[1])
    return np.pad(x, ((0, 0), (0, Vp - x.shape[1])),
                  constant_values=-np.inf).astype(F)


@pytest.mark.parametrize("B,V", [(1, 128), (4, 1000), (2, 4096),
                                 (3, 50257)])
def test_emulated_cluster_kernel_threshold(B, V):
    logits = _logits(B * V, B, V)
    lp = _pad(logits)
    C, L = tk.plan_cluster(lp.shape[1])
    j = jops.sqs_threshold(jnp.asarray(logits), jnp.full((B,), 2e-3),
                           ell=100)
    for r in range(B):
        b, mask, K, _ = emulated_kernel(lp[r], F(2e-3), 1.0, 100, 0, C, L)
        np.testing.assert_array_equal(mask[:V], np.asarray(j.mask)[r])
        np.testing.assert_array_equal(
            b[:V], np.round(np.asarray(j.q_hat)[r] * 100))
        assert K == int(j.K[r]) and b.sum() == 100


@pytest.mark.parametrize("V,K,ell", [(1000, 8, 100), (1000, 64, 100),
                                     (4096, 16, 50), (50257, 256, 1000),
                                     (512, 1, 100)])
def test_emulated_cluster_kernel_topk(V, K, ell):
    logits = _logits(V + K, 3, V)
    lp = _pad(logits)
    C, L = tk.plan_cluster(lp.shape[1])
    j = jops.sqs_topk(jnp.asarray(logits), K, ell=ell)
    for r in range(3):
        x = lp[r]
        e = np.exp(x - x.max())
        lo, hi, _ = topk_cut(e / cluster_sum(e, L), K, tk.BISECT_ITERS)
        b, mask, Kr, q = emulated_kernel(x, lo, 1.0, ell, K, C, L)
        assert Kr == K and b.sum() == ell
        assert (q >= lo).sum() >= K
        np.testing.assert_array_equal(mask[:V], np.asarray(j.mask)[r])
        np.testing.assert_array_equal(
            b[:V], np.round(np.asarray(j.q_hat)[r] * ell))
