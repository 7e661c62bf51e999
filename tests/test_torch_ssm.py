"""The port's sequence mixers (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``), in float32 on the CPU, on the
reference's initial parameters copied into the port's modules and
numpy-seeded inputs and states: outputs, final states and every leaf of
the per-position trajectories agree to ATOL (the two frameworks order
their float sums differently; Mamba's scan runs the reference's
associative combine order, and lengths 19 and 264 cross an odd scan tail
and chunk boundaries).  The port's own sequence forms agree with its
step loops to the reference's tolerances (tests/test_layers_units.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.bridge import SSM_LEAVES  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

ATOL = 2e-5
B = 2
# the reference's seq-vs-step tolerances (tests/test_layers_units.py)
SEQ_STEP_ATOL = {"mamba": 2e-5, "mlstm": 3e-4, "slstm": 2e-5}

ARCH = {"mamba": "jamba-1.5-large-398b", "mlstm": "xlstm-1.3b",
        "slstm": "xlstm-1.3b"}
# the reduced widths of the reference's unit tests
OVER = {"mamba": dict(d_model=64, mamba_dt_rank=8),
        "mlstm": dict(d_model=64, n_heads=2, head_dim=32),
        "slstm": dict(d_model=64, n_heads=2, head_dim=32)}
INIT = {"mamba": jssm.init_mamba, "mlstm": jssm.init_mlstm,
        "slstm": jssm.init_slstm}
MAKE_STATE = {"mamba": lambda c, b: jssm.make_mamba_state(c, b,
                                                           jnp.float32),
              "mlstm": jssm.make_mlstm_state,
              "slstm": jssm.make_slstm_state}
SEQ = {"mamba": (jssm.mamba_seq, ssm.mamba_seq),
       "mlstm": (jssm.mlstm_seq_recurrent, ssm.mlstm_seq_recurrent),
       "slstm": (jssm.slstm_seq, ssm.slstm_seq)}
STEP = {"mamba": (jssm.mamba_step, ssm.mamba_step),
        "mlstm": (jssm.mlstm_step, ssm.mlstm_step),
        "slstm": (jssm.slstm_step, ssm.slstm_step)}


def _cfgs(kind):
    jc = dataclasses.replace(jconfigs.smoke_variant(
        jconfigs.get_config(ARCH[kind])), **OVER[kind])
    tc = dataclasses.replace(configs.smoke_variant(
        configs.get_config(ARCH[kind])), **OVER[kind])
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _mixer(kind, seed=0):
    """(reference config, its parameters, port config, port module
    holding the same values)."""
    jc, tc = _cfgs(kind)
    jp = INIT[kind](jax.random.PRNGKey(seed), jc)
    m = ssm.MIXERS[kind](tc, torch.float32, "cpu")
    assert sorted(jp) == sorted(SSM_LEAVES[kind])
    with torch.no_grad():
        for name in SSM_LEAVES[kind]:
            prm = getattr(m, name)
            assert tuple(prm.shape) == jp[name].shape, name
            prm.copy_(torch.from_numpy(np.array(jp[name])))
    return jc, jp, tc, m


def _state(kind, jc, rng):
    """A random mid-sequence state (m finite, n and h nonzero)."""
    st = jax.tree.map(np.asarray, MAKE_STATE[kind](jc, B))
    out = {}
    for name, a in st.items():
        r = rng.standard_normal(a.shape).astype(np.float32)
        out[name] = (r * 0.3 if name != "n" else np.abs(r) + 0.5) \
            if name != "m" else r
    return out


def _x(rng, S, d):
    return (rng.standard_normal((B, S, d)) * 0.3).astype(np.float32)


def _close(ref, got, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(ref), got.detach().numpy(),
                               atol=atol, rtol=0, err_msg=what)


def _tree_close(ref, got, atol=ATOL, what=""):
    assert sorted(ref) == sorted(got), what
    for name in ref:
        assert tuple(got[name].shape) == np.asarray(ref[name]).shape, name
        _close(ref[name], got[name], atol, f"{what}{name}")


# lengths 1 (a decode), 4 (a verify), 19 (an odd scan tail); only
# Mamba's scan is chunked, so only it also runs 264 (33 chunks of 8)
SEQ_CASES = [(kind, S) for kind in ("mamba", "mlstm", "slstm")
             for S in (1, 4, 19)] + [("mamba", 264)]


@pytest.mark.parametrize("kind,S", SEQ_CASES)
def test_seq_state_and_trajectory_match_reference(kind, S):
    jc, jp, tc, m = _mixer(kind)
    rng = np.random.default_rng(S)
    x = _x(rng, S, jc.d_model)
    st = _state(kind, jc, rng)
    jfn, tfn = SEQ[kind]
    jst = jax.tree.map(jnp.asarray, st)
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    ro, rs, rt = jfn(jc, jp, jnp.asarray(x), state=jst, return_state=True,
                     collect_traj=True)
    with torch.no_grad():
        go, gs, gt = tfn(tc, m, torch.from_numpy(x), state=tst,
                         return_state=True, collect_traj=True)
        go2, gs2 = tfn(tc, m, torch.from_numpy(x), state=tst,
                       return_state=True)
        go3 = tfn(tc, m, torch.from_numpy(x))
    _close(ro, go, what="out ")
    _tree_close(rs, gs, what="state ")
    _tree_close(rt, gt, what="trajectory ")
    assert torch.equal(go, go2) and all(torch.equal(gs[k], gs2[k])
                                        for k in gs)
    _close(jfn(jc, jp, jnp.asarray(x)), go3, what="stateless ")
    # the trajectory's last position is the final state
    for name in gs:
        assert torch.equal(gt[name][:, -1], gs[name])


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_step_matches_reference(kind):
    jc, jp, tc, m = _mixer(kind, seed=3)
    rng = np.random.default_rng(7)
    x = _x(rng, 1, jc.d_model)
    st = _state(kind, jc, rng)
    jfn, tfn = STEP[kind]
    ro, rs = jfn(jc, jp, jnp.asarray(x), jax.tree.map(jnp.asarray, st))
    with torch.no_grad():
        go, gs = tfn(tc, m, torch.from_numpy(x),
                     {k: torch.from_numpy(v) for k, v in st.items()})
    _close(ro, go, what="out ")
    _tree_close(rs, gs, what="state ")


def test_mlstm_parallel_matches_reference():
    jc, jp, tc, m = _mixer("mlstm", seed=5)
    x = _x(np.random.default_rng(11), 13, jc.d_model)
    with torch.no_grad():
        got = ssm.mlstm_parallel(tc, m, torch.from_numpy(x))
    _close(jssm.mlstm_parallel(jc, jp, jnp.asarray(x)), got)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_seq_form_matches_step_loop(kind):
    """The port's own sequence form (for mLSTM the parallel one) against
    its step loop from the zero state, as the reference's unit tests."""
    _, _, tc, m = _mixer(kind, seed=0)
    S = {"mamba": 19, "mlstm": 11, "slstm": 9}[kind]
    x = torch.from_numpy(_x(np.random.default_rng(1), S, tc.d_model))
    with torch.no_grad():
        seq = ssm.mlstm_parallel(tc, m, x) if kind == "mlstm" else \
            SEQ[kind][1](tc, m, x)
        st = ssm.make_state(tc, kind, B, torch.float32, "cpu")
        outs = []
        for t in range(S):
            o, st = STEP[kind][1](tc, m, x[:, t:t + 1], st)
            outs.append(o)
    np.testing.assert_allclose(seq.numpy(), torch.cat(outs, 1).numpy(),
                               atol=SEQ_STEP_ATOL[kind], rtol=0)


def test_associative_scan_is_an_inclusive_scan():
    """The combine-order scan equals the sequential recurrence."""
    g = torch.Generator().manual_seed(0)
    for n in (1, 2, 3, 8, 19):
        A = torch.rand((2, n, 3), generator=g)
        h = torch.randn((2, n, 3), generator=g)
        Acum, hs = ssm._associative_scan(A, h)
        a, s = torch.ones(2, 3), torch.zeros(2, 3)
        for t in range(n):
            a, s = a * A[:, t], A[:, t] * s + h[:, t]
            torch.testing.assert_close(Acum[:, t], a)
            torch.testing.assert_close(hs[:, t], s)


def test_softplus_and_gelu_follow_jax():
    x = np.linspace(-40, 40, 4001, dtype=np.float32)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(ssm._softplus(tx).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=2e-7,
                               atol=0)
    np.testing.assert_allclose(ssm._log_sigmoid(tx).numpy(),
                               np.asarray(jax.nn.log_sigmoid(x)),
                               rtol=2e-7, atol=0)
    xs = x[np.abs(x) <= 8]
    np.testing.assert_allclose(ssm._gelu(torch.from_numpy(xs)).numpy(),
                               np.asarray(jax.nn.gelu(xs)), rtol=0,
                               atol=2e-6)
