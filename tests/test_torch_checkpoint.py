"""Checkpoints cross between the frameworks, and a pair trained in the
port serves in both, in float32 on the CPU:

- the port's ``checkpoint.save(bridge.to_jax_tree(model))`` loads with
  the reference's ``checkpoint.load(like=...)`` into the same arrays, and
  the reference's ``forward_logits`` on them agrees with the port's to
  1e-4; the reference's checkpoint loads in the port
  (``checkpoint.load`` + ``bridge.from_jax``) the same way;
- the paper's pair at smoke size (``gptneo-1.3b`` and its 2x draft),
  trained in the port on ``benchmarks/common.py`` ``trained_pair``'s
  corpus and loaded from its checkpoints into both frameworks, runs
  ``EdgeCloudEngine`` with accepted tokens, equal token streams, accept
  counts and rejections, and payloads equal but for the C-SQS float32
  beta within the pin of tests/test_torch_engine.py (ROADMAP Queue 3
  item 3; at most 3 ulps observed here, 3 to 6 of 24 drafts accepted);
- the launchers: ``launch.train`` saves checkpoints the reference loads,
  and ``launch.serve`` serves them (``--target-ckpt``/``--draft-ckpt``);
- the SSM and hybrid family: smoke ``xlstm-1.3b`` and
  ``jamba-1.5-large-398b`` checkpoints cross both ways as above, their
  full period-8 patterns (two periods at small widths) map layer i to
  row i // 8 of ``body/p{i % 8}``, and ``bridge.init_params`` gives the
  reference's constant leaves.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import EdgeCloudEngine as RefEngine  # noqa: E402
from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core import MethodConfig as RefMethodConfig  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core import wire as twire  # noqa: E402
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,  # noqa: E402
                                     MethodConfig)
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

from test_torch_engine import _draft_ulps, _verdict_ulps  # noqa: E402

ATOL = 1e-4
ROUNDS, L_MAX, K = 3, 4, 16
TARGET_STEPS, DRAFT_STEPS = 120, 60
BETA_ULPS = 22          # the largest beta pin of tests/test_torch_engine.py



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size models run fastest on one intra-op thread, and the test
    workers share the machine's cores: torch's default of one thread a
    core per worker oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _cfgs(name, draft=False):
    jc = jconfigs.smoke_variant(jconfigs.get_config(name))
    tc = configs.smoke_variant(configs.get_config(name))
    if draft:
        jc, tc = jconfigs.draft_variant(jc, 2), configs.draft_variant(tc, 2)
    assert jc.__dict__ == tc.__dict__
    return jc, tc


def _like(cfg):
    shapes = jax.eval_shape(lambda k: init_params(cfg, k),
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _tokens(vocab):
    return np.random.default_rng(3).integers(0, vocab, (2, 11)).astype(
        np.int32)


def _assert_same_tree(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), \
        jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=jax.tree_util.keystr(path))


CKPT_ARCHS = ["gptneo-1.3b", "qwen2-moe-a2.7b", "xlstm-1.3b",
              "jamba-1.5-large-398b"]


@pytest.mark.parametrize("name", CKPT_ARCHS)
def test_port_checkpoint_loads_in_reference(name, tmp_path):
    jc, tc = _cfgs(name)
    model = bridge.seeded_model(tc, 4, "cpu", trainable=True)
    path = os.path.join(tmp_path, "port")
    tckpt.save(path, bridge.to_jax_tree(model), meta={"arch": tc.name})
    assert tckpt.load_meta(path) == jckpt.load_meta(path) == \
        {"arch": tc.name}
    loaded = jckpt.load(path, like=_like(jc))
    _assert_same_tree(loaded, bridge.to_jax_tree(model))
    toks = _tokens(jc.vocab)
    ref = jmodel.forward_logits(jc, loaded, jnp.asarray(toks))
    with torch.no_grad():
        got = tmodel.forward_logits(model, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("name", CKPT_ARCHS)
def test_reference_checkpoint_loads_in_port(name, tmp_path):
    jc, tc = _cfgs(name)
    params = init_params(jc, jax.random.PRNGKey(5))
    path = os.path.join(tmp_path, "ref.npz")
    jckpt.save(path, params)
    tree = tckpt.load(path)
    _assert_same_tree(tree, jax.tree.map(np.asarray, params))
    model = bridge.from_jax(tree, tc, device="cpu")
    _assert_same_tree(bridge.to_jax_tree(model),
                      jax.tree.map(np.asarray, params))
    toks = _tokens(jc.vocab)
    ref = jmodel.forward_logits(jc, params, jnp.asarray(toks))
    with torch.no_grad():
        got = tmodel.forward_logits(model, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


# the full configs' period-8 patterns (the smoke variants keep one layer
# of each distinct kind) at small widths, two periods deep
PERIOD8 = {"xlstm-1.3b": dict(n_layers=16, d_model=64, n_heads=2,
                              n_kv_heads=2, head_dim=32, vocab=256,
                              dtype="float32"),
           "jamba-1.5-large-398b": dict(
               n_layers=16, d_model=64, n_heads=4, n_kv_heads=2,
               head_dim=16, d_ff=128, vocab=256, n_experts=4, moe_top_k=2,
               d_expert=32, mamba_dt_rank=8, dtype="float32")}


@pytest.mark.parametrize("name", sorted(PERIOD8))
def test_period_8_stacks_cross_both_ways(name, tmp_path):
    """Layer i is row i // 8 of ``body/p{i % 8}``: the reference's
    period-stacked parameters load in the port, come back equal through
    ``to_jax_tree`` and a checkpoint, and give the reference's logits."""
    import dataclasses
    jc = dataclasses.replace(jconfigs.get_config(name), **PERIOD8[name])
    tc = dataclasses.replace(configs.get_config(name), **PERIOD8[name])
    assert jc.period == 8 and jc.n_periods == 2
    params = jax.tree.map(np.asarray,
                          init_params(jc, jax.random.PRNGKey(6)))
    model = bridge.from_jax(params, tc, device="cpu")
    assert [blk.block_type for blk in model.layers] == \
        list(jc.block_pattern) * 2
    path = os.path.join(tmp_path, "p8")
    tckpt.save(path, bridge.to_jax_tree(model))
    _assert_same_tree(jckpt.load(path, like=_like(jc)), params)
    toks = _tokens(jc.vocab)
    ref = jmodel.forward_logits(jc, jax.tree.map(jnp.asarray, params),
                                jnp.asarray(toks))
    with torch.no_grad():
        got = tmodel.forward_logits(model, torch.from_numpy(toks).long())
    # 16 layers deep, rounding grows layer by layer (the recurrent models
    # amplify it most): the reference's cache-consistency bound
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-4)


@pytest.mark.parametrize("name", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_init_params_constant_leaves_equal_reference(name):
    """``bridge.init_params`` gives every leaf the reference initialises
    to a constant (norms, biases, D and dt_bias, the forget-gate biases of
    mLSTM and sLSTM) the reference's value exactly; Mamba's A_log =
    log(1..d_state) within one float32 ulp (torch's log(7) is the
    correctly rounded one, XLA's an ulp below); and each random leaf the
    reference's scale 1/sqrt(fan_in) within 20%."""
    jc, tc = _cfgs(name)
    ref = jax.tree.map(np.asarray, init_params(jc, jax.random.PRNGKey(0)))
    got = bridge.to_jax_tree(bridge.init_params(
        tc, torch.Generator().manual_seed(0), device="cpu"))
    flat_r = {jax.tree_util.keystr(p): r for p, r in
              jax.tree_util.tree_leaves_with_path(ref)}
    flat_g = {jax.tree_util.keystr(p): g for p, g in
              jax.tree_util.tree_leaves_with_path(got)}
    assert sorted(flat_r) == sorted(flat_g)
    n_const = 0
    for key, g in flat_g.items():
        r = flat_r[key]
        assert g.shape == r.shape, key
        if "A_log" in key:
            ulps = np.abs(g.view(np.int32).astype(np.int64)
                          - r.view(np.int32).astype(np.int64))
            assert ulps.max() <= 1, key
            n_const += 1
        elif "b_in" in key or np.all(r == r.flat[0]):
            np.testing.assert_array_equal(g, r, err_msg=key)
            n_const += 1
        else:
            ratio = float(g.std()) / float(r.std())
            assert abs(ratio - 1.0) < 0.2, (key, ratio)
    assert n_const == {"xlstm-1.3b": 8, "jamba-1.5-large-398b": 15}[name]


def _train(cfg, steps, seed, data):
    """``benchmarks/common.py`` ``_train`` in the port."""
    model = bridge.seeded_model(cfg, seed, "cpu", trainable=True)
    step = ttrainer.make_train_step(
        cfg, topt.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=steps))
    st = topt.init_state(ttrainer.parameters(model))
    first = None
    for b in data.batches(steps):
        model, st, m = step(model, st,
                            {"tokens": torch.from_numpy(b["tokens"]).long()})
        first = float(m["loss"]) if first is None else first
    return model, first, float(m["loss"])


@pytest.fixture(scope="module")
def trained_pair(tmp_path_factory):
    """Train the smoke pair in the port, save both, and load them into
    each framework."""
    root = str(tmp_path_factory.mktemp("pair"))
    (jtc, ttc), (jdc, tdc) = _cfgs("gptneo-1.3b"), \
        _cfgs("gptneo-1.3b", draft=True)
    data = SyntheticLM(DataConfig(vocab=ttc.vocab, seq_len=48, batch=16,
                                  p_bigram=0.85, jitter=2, seed=5))
    out = {}
    for role, jc, tc, steps, seed in (("target", jtc, ttc, TARGET_STEPS, 1),
                                      ("draft", jdc, tdc, DRAFT_STEPS, 2)):
        model, first, last = _train(tc, steps, seed, data)
        assert last < first - 0.5, (role, first, last)
        path = os.path.join(root, role)
        tckpt.save(path, bridge.to_jax_tree(model))
        out[role] = (jc, jckpt.load(path, like=_like(jc)), tc,
                     bridge.from_jax(tckpt.load(path), tc, device="cpu"))
    prompts = data.sample(2, 8)[:, :-1]
    return out, prompts


def _record(eng, draft_attr, verdict_attr):
    """Wrap an engine's draft and verdict packing to keep their bytes."""
    packed, verdicts = [], []
    draft, pack_verdict = getattr(eng.edge, draft_attr), \
        getattr(eng, verdict_attr)

    def record_draft(*a, **kw):
        db = draft(*a, **kw)
        packed.append(dict(db.packed))
        verdicts.append({})
        return db

    def record_verdict(slot, v):
        verdicts[-1][slot] = pack_verdict(slot, v)
        return verdicts[-1][slot]
    setattr(eng.edge, draft_attr, record_draft)
    setattr(eng, verdict_attr, record_verdict)
    return packed, verdicts


@pytest.mark.parametrize("method", ["ksqs", "csqs"])
def test_trained_pair_serves_in_both_frameworks(method, trained_pair):
    pair, prompts = trained_pair
    jtc, jtp, ttc, tm = pair["target"]
    jdc, jdp, tdc, dm = pair["draft"]
    ref = RefEngine(jdc, jdp, jtc, jtp, RefMethodConfig(method, K=K),
                    RefEngineConfig(L_max=L_MAX), seed=11)
    packed, verdicts = _record(ref, "draft", "pack_verdict_slot")
    rounds, toks = ref.run(prompts, ROUNDS)
    eng = EdgeCloudEngine(tdc, dm, ttc, tm,
                          MethodConfig(method, K=K, use_kernels=False),
                          EngineConfig(L_max=L_MAX), seed=11, device="cpu")
    got, got_toks = eng.run(prompts, ROUNDS)
    assert got_toks == toks, "token streams diverged"
    assert sum(int(r["n_accept"].sum()) for r in got) > 0
    fmt = twire.WireFormat(V=ttc.vocab, ell=100, L_max=L_MAX)
    for i, (r, g) in enumerate(zip(rounds, got)):
        for key in ("n_accept", "L_live", "rejected"):
            np.testing.assert_array_equal(r[key], g[key], err_msg=key)
        assert sorted(g["packed"]) == sorted(packed[i])
        for slot, data in packed[i].items():
            assert _draft_ulps(method, fmt, data, g["packed"][slot]) <= \
                BETA_ULPS
        for slot, data in verdicts[i].items():
            assert _verdict_ulps(method, fmt, data,
                                 g["verdict_packed"][slot]) <= BETA_ULPS


def test_train_and_serve_launchers(tmp_path, capsys):
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    common = ["--arch", "gptneo-1.3b", "--smoke", "--device", "cpu",
              "--steps", "3", "--batch", "4", "--seq", "16",
              "--log-every", "1"]
    paths = {}
    for role, extra in (("target", []), ("draft", ["--draft-scale", "2"])):
        paths[role] = os.path.join(tmp_path, role)
        hist = ttrain.main(common + extra + ["--out", paths[role]])
        assert [h["step"] for h in hist] == [0, 1, 2]
        meta = tckpt.load_meta(paths[role])
        jc, tc = _cfgs("gptneo-1.3b", draft=bool(extra))
        assert (meta["arch"], meta["steps"]) == (tc.name, 3)
        _assert_same_tree(jckpt.load(paths[role], like=_like(jc)),
                          tckpt.load(paths[role]))
    serve = ["--arch", "gptneo-1.3b", "--smoke", "--device", "cpu",
             "--target-ckpt", paths["target"], "--draft-ckpt",
             paths["draft"]]
    rounds = tserve.main(serve + ["--rounds", "2", "--batch", "2"])
    assert len(rounds) == 2
    assert "gptneo-1.3b-smoke <- gptneo-1.3b-smoke-draft2x" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        tserve.main(serve + ["--trace", "--transport", "tcp"])
    assert exc.value.code == 2
