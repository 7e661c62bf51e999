"""Training in the port against ``repro.train`` in float32 on the CPU,
with the parameters of smoke variants filled from a numpy seed and
bridged:

- ``schedule`` gives the reference's bits at step 0, the end of the
  warmup, the middle of the cosine and the last step;
- one ``apply_updates`` from a nonzero state (clipping active) gives the
  reference's parameters, m and v within 1e-6 relative, with the
  reference's decay rule: body norms and biases, stacked over layers
  there, are decayed, ``final_norm`` is not;
- ``train_loss`` (loss within 1e-5; ce, aux, accuracy) and every gradient
  leaf, stacked by ``to_jax_tree``, within 1e-4 * max(1, max|g_ref|), for
  a dense GQA config with biases, the paper's MHA pair, the MoE family
  (a random batch, and one that overflows the experts' capacity) and the
  SSM / hybrid family (xLSTM's parallel mLSTM and sLSTM, Jamba's Mamba
  with attention and MoE);
- ``microbatches=4`` equals ``microbatches=1`` (as tests/test_train.py);
- a 10-step loss curve from the same parameters and batches.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
# the reference's CPU cosine differs from torch's by an ulp at a few
# steps between these points; at them both give the same bits
SCHEDULES = [jopt.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=300),
             jopt.AdamWConfig(),
             jopt.AdamWConfig(lr=1.0, warmup_steps=7, total_steps=33)]



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size models run fastest on one intra-op thread, and the test
    workers share the machine's cores: torch's default of one thread a
    core per worker oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _cfgs(name):
    jc = jconfigs.smoke_variant(jconfigs.get_config(name))
    tc = configs.smoke_variant(configs.get_config(name))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _numpy_tree(cfg, seed, scale=0.05):
    """A tree of the reference's parameter shapes from a numpy seed: norms
    near 1, small normals elsewhere (biases included)."""
    shapes = jax.eval_shape(lambda k: init_params(cfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        x = rng.standard_normal(s.shape)
        if "norm" in jax.tree_util.keystr(path):
            return (1.0 + 0.1 * x).astype(np.float32)
        return (x * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_list(tree, tcfg):
    """A numpy tree as tensors in ``leaves`` order (through a model)."""
    m = bridge.from_jax(tree, tcfg, device="cpu", trainable=True)
    return [p.detach().clone() for p in ttrainer.parameters(m)]


def _assert_tree_close(got, ref, rtol, scale_floor=None, what=""):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_g) == len(flat_r)
    for path, g in flat_g:
        r = np.asarray(flat_r[path])
        assert g.shape == r.shape, (what, path)
        if scale_floor is None:
            np.testing.assert_allclose(g, r, rtol=rtol, atol=0,
                                       err_msg=f"{what} {path}")
        else:
            tol = rtol * max(scale_floor, float(np.abs(r).max()))
            err = float(np.abs(g - r).max())
            assert err <= tol, (what, jax.tree_util.keystr(path), err, tol)


@pytest.mark.parametrize("oc", SCHEDULES, ids=["pair", "default", "short"])
def test_schedule_matches_reference_bits(oc):
    mid = (oc.warmup_steps + oc.total_steps) // 2
    for step in (0, oc.warmup_steps, mid, oc.total_steps):
        ref = np.float32(jopt.schedule(oc, step))
        got = topt.schedule(oc, step).numpy()
        assert got.dtype == np.float32
        assert got.view(np.int32) == ref.view(np.int32), (step, got, ref)


def test_apply_updates_matches_reference_with_its_decay_rule():
    """From a random state at step 3, gradients large enough to clip:
    params, m and v within 1e-6 of each leaf's largest magnitude (a
    parameter that p - lr * delta brings near 0 keeps the operands' ulps,
    so an elementwise relative bound would measure cancellation).  The decay mask is the reference's ndim >= 2 on the
    stacked tree: norm1/norm2 and b_q/b_k/b_v decayed, final_norm not."""
    jc, tc = _cfgs("qwen2.5-3b")
    oc = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    params = _numpy_tree(jc, 1)
    grads = _numpy_tree(jc, 2, scale=0.5)
    m = _numpy_tree(jc, 3, scale=0.01)
    v = jax.tree.map(lambda x: np.abs(x) * 1e-2, _numpy_tree(jc, 4))
    state = {"m": m, "v": v, "step": jnp.asarray(3, jnp.int32)}
    rp, rs, rm = jax.jit(functools.partial(jopt.apply_updates, oc))(
        params, grads, state)
    assert float(rm["grad_norm"]) > oc.grad_clip          # clipping active

    model = bridge.from_jax(params, tc, device="cpu", trainable=True)
    mask = dict(zip([path for _, path in bridge.leaves(model)],
                    ttrainer.decay_mask(model)))
    assert mask[("final_norm",)] is False
    assert mask[("body", "p0", "norm1", 0)] is True
    assert mask[("body", "p0", "attn", "b_q", 1)] is True
    tstate = {"m": _port_list(m, tc), "v": _port_list(v, tc),
              "step": torch.tensor(3, dtype=torch.int32)}
    _, tstate, tm = topt.apply_updates(
        oc, ttrainer.parameters(model), _port_list(grads, tc), tstate,
        ttrainer.decay_mask(model))
    assert int(tstate["step"]) == 4
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-6)
    # jitted, the reference's warmup divides by a constant as a product
    # with its reciprocal: an ulp apart from the eager schedule here
    np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=1e-6)
    for got, ref, what in ((bridge.to_jax_tree(model), rp, "params"),
                           (bridge.to_jax_tree(model, tstate["m"]), rs["m"],
                            "m"),
                           (bridge.to_jax_tree(model, tstate["v"]), rs["v"],
                            "v")):
        _assert_tree_close(got, ref, 1e-6, scale_floor=0.0, what=what)


def _batch(name, jc, kind):
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab, (2, 17)).astype(np.int32)
    if kind == "overflow":
        # a shared prefix routes 24 of the 32 tokens to the same two
        # experts: past the capacity of 24 per expert
        toks[:, :13] = 5
    return toks


LOSS_CASES = [("qwen2.5-3b", "random"), ("gptneo-1.3b", "random"),
              ("qwen2-moe-a2.7b", "random"), ("qwen2-moe-a2.7b", "overflow"),
              ("xlstm-1.3b", "random"), ("jamba-1.5-large-398b", "random")]


@pytest.mark.parametrize("name,kind", LOSS_CASES)
def test_train_loss_and_grads_match_reference(name, kind):
    jc, tc = _cfgs(name)
    params = _numpy_tree(jc, 11)
    toks = _batch(name, jc, kind)

    def loss_fn(p):
        return jmodel.train_loss(jc, p, {"tokens": jnp.asarray(toks)})
    (rl, rmet), rg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)

    model = bridge.from_jax(params, tc, device="cpu", trainable=True)
    loss, met = tmodel.train_loss(model,
                                  {"tokens": torch.from_numpy(toks).long()})
    loss.backward()
    assert abs(float(loss) - float(rl)) <= LOSS_ATOL
    for key in ("ce", "aux"):
        assert abs(float(met[key]) - float(rmet[key])) <= LOSS_ATOL, key
    assert float(met["accuracy"]) == float(rmet["accuracy"])
    grads = bridge.to_jax_tree(model, [p.grad for p in
                                       ttrainer.parameters(model)])
    _assert_tree_close(grads, rg, GRAD_RTOL, scale_floor=1.0, what="grads")
    if kind == "overflow":
        # dropped tokens: the dropless oracle's cross entropy differs
        with torch.no_grad():
            lg = tmodel.forward_logits(model,
                                       torch.from_numpy(toks[:, :-1]).long())
        nll = -torch.log_softmax(lg, -1).gather(
            -1, torch.from_numpy(toks[:, 1:]).long()[..., None])
        assert abs(float(nll.mean()) - float(met["ce"])) > 1e-4
        assert float(met["aux"]) > 0


def test_microbatch_equals_full_batch_grads():
    jc, tc = _cfgs("qwen2.5-3b")
    data = JSyntheticLM(JDataConfig(vocab=jc.vocab, seq_len=16, batch=8))
    params = _numpy_tree(jc, 0)
    batch = {"tokens": torch.from_numpy(data.sample()).long()}
    oc = topt.AdamWConfig(lr=1e-3, total_steps=10)
    out = []
    for mb in (1, 4):
        model = bridge.from_jax(params, tc, device="cpu", trainable=True)
        step = ttrainer.make_train_step(tc, oc, microbatches=mb)
        _, _, met = step(model, topt.init_state(ttrainer.parameters(model)),
                         batch)
        out.append((float(met["loss"]), bridge.to_jax_tree(model)))
    assert abs(out[0][0] - out[1][0]) < 1e-4
    d = max(float(np.abs(a - b).max()) for a, b in
            zip(jax.tree.leaves(out[0][1]), jax.tree.leaves(out[1][1])))
    assert d < 5e-5, d


def test_loss_curve_matches_reference():
    """Ten steps from the same parameters on the same batches: the losses
    agree within 1e-4 (the max observed is 1.4e-6: the curves separate
    only by float32 rounding)."""
    jc, tc = _cfgs("gptneo-1.3b")
    data = JSyntheticLM(JDataConfig(vocab=jc.vocab, seq_len=24, batch=8,
                                    p_bigram=0.85, jitter=2, seed=5))
    batches = [b["tokens"] for b in data.batches(10)]
    params = _numpy_tree(jc, 21)
    oc = jopt.AdamWConfig(lr=2e-3, warmup_steps=3, total_steps=10)
    jstep = jax.jit(jtrainer.make_train_step(jc, oc))
    jp, js, ref = params, jopt.init_state(params), []
    for b in batches:
        jp, js, m = jstep(jp, js, {"tokens": jnp.asarray(b)})
        ref.append(float(m["loss"]))
    model = bridge.from_jax(params, tc, device="cpu", trainable=True)
    tstep = ttrainer.make_train_step(
        tc, topt.AdamWConfig(**dataclasses.asdict(oc)))
    ts, got = topt.init_state(ttrainer.parameters(model)), []
    for b in batches:
        model, ts, m = tstep(model, ts, {"tokens": torch.from_numpy(b).long()})
        got.append(float(m["loss"]))
    assert ref[-1] < ref[0]
    np.testing.assert_allclose(got, ref, atol=1e-4)
