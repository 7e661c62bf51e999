"""The port's dense GQA model on bridged parameters against
repro.models, in float32 on the CPU: prefill, extend (L = 1 and 5) and
decode logits agree to atol 1e-4 (torch and XLA reduce in different
orders; the reference's own cache-consistency test allows 3e-4).  Every
architecture the port names is the reference's config field for field
(full size, smoke and draft), and its smoke model's prefill logits agree
to the same atol (an encoder-decoder model's over seeded stub frames);
``ASSIGNED`` is the reference's list, in its order."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import (decode_step, extend_step, init_params,  # noqa: E402
                          prefill)
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

ATOL = 1e-4


def _numpy_params(cfg, seed):
    """The reference's parameter tree, filled from a numpy seed: ones for
    norms, small normals elsewhere (biases included, so they are
    exercised)."""
    shapes = jax.eval_shape(lambda k: init_params(cfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if "norm" in jax.tree_util.keystr(path):
            return np.ones(s.shape, np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _pairs():
    jt = jconfigs.smoke_variant(jconfigs.get_config("qwen2.5-3b"))
    tt = configs.smoke_variant(configs.get_config("qwen2.5-3b"))
    return [(jt, tt), (jconfigs.draft_variant(jt, 2),
                       configs.draft_variant(tt, 2))]


@pytest.fixture(scope="module", params=[0, 1], ids=["target", "draft2x"])
def bridged(request):
    jcfg, tcfg = _pairs()[request.param]
    assert jcfg.__dict__ == tcfg.__dict__      # the port's config copy
    params = _numpy_params(jcfg, 10 + request.param)
    model = bridge.from_jax(params, tcfg, device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, params), model


def _toks(rng, shape, V):
    return rng.integers(0, V, shape).astype(np.int32)


def test_prefill_logits_and_cache(bridged):
    jcfg, jp, m = bridged
    toks = _toks(np.random.default_rng(0), (2, 11), jcfg.vocab)
    lj, cj = prefill(jcfg, jp, jnp.asarray(toks), cache_len=24)
    lt, ct = tmodel.prefill(m, torch.from_numpy(toks).long(), cache_len=24)
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)
    assert len(ct) == jcfg.n_layers
    for i, c in enumerate(ct):
        for name in ("k", "v"):
            ref = np.asarray(cj["body"]["p0"][name][i])
            assert c[name].shape == ref.shape
            np.testing.assert_allclose(ref, c[name].numpy(), atol=ATOL)


@pytest.mark.parametrize("L", [1, 5])
def test_extend_and_decode_logits(bridged, L):
    jcfg, jp, m = bridged
    rng = np.random.default_rng(L)
    toks = _toks(rng, (3, 9), jcfg.vocab)
    _, cj = prefill(jcfg, jp, jnp.asarray(toks), cache_len=32)
    _, ct = tmodel.prefill(m, torch.from_numpy(toks).long(), cache_len=32)
    pos = np.array([9, 7, 4], np.int32)         # ragged rows
    new = _toks(rng, (3, L), jcfg.vocab)
    lj, cj = extend_step(jcfg, jp, jnp.asarray(new), cj, jnp.asarray(pos))
    lt, ct, _ = tmodel.extend_step(m, torch.from_numpy(new).long(), ct,
                                   torch.from_numpy(pos).long())
    assert lt.shape == (3, L, jcfg.vocab) and lt.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)
    tok = _toks(rng, (3,), jcfg.vocab)
    pos = pos + L
    lj, _ = decode_step(jcfg, jp, jnp.asarray(tok), cj, jnp.asarray(pos))
    lt, _ = tmodel.decode_step(m, torch.from_numpy(tok).long(), ct,
                               torch.from_numpy(pos).long())
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)


def test_init_params_distributions():
    cfg = configs.smoke_variant(configs.get_config("qwen2.5-3b"))
    m = bridge.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    blk = m.layers[0]
    assert torch.equal(blk.norm1, torch.ones_like(blk.norm1))
    assert torch.equal(blk.attn.b_q, torch.zeros_like(blk.attn.b_q))
    std = float(blk.mlp.w_down.std())
    assert abs(std * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    m2 = bridge.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert torch.equal(m.embedding, m2.embedding)      # seeded, repeatable


@pytest.mark.parametrize("name", configs.ASSIGNED
                         + ["gptneo-125m", "gptneo-1.3b"])
def test_config_and_smoke_logits_match_reference(name):
    full = (jconfigs.get_config(name), configs.get_config(name))
    smoke = tuple(c.smoke_variant(f) for c, f in zip((jconfigs, configs),
                                                    full))
    draft = tuple(c.draft_variant(f, 2) for c, f in zip((jconfigs, configs),
                                                       full))
    for ref, port in (full, smoke, draft):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    jcfg, tcfg = smoke
    params = _numpy_params(jcfg, 30)
    model = bridge.from_jax(params, tcfg, device="cpu")
    toks = _toks(np.random.default_rng(1), (2, 7), jcfg.vocab)
    # an encoder-decoder model prefills over the frontend stub's frames
    # (the reference's prefill needs them; tests/test_models.py)
    enc = None
    if jcfg.n_encoder_layers:
        enc = (np.random.default_rng(2).standard_normal(
            (2, 8, jcfg.d_model)) * 0.02).astype(np.float32)
    lj, _ = prefill(jcfg, jax.tree.map(jnp.asarray, params),
                    jnp.asarray(toks),
                    enc_embeds=None if enc is None else jnp.asarray(enc))
    lt, _ = tmodel.prefill(model, torch.from_numpy(toks).long(),
                           enc_embeds=None if enc is None
                           else torch.from_numpy(enc))
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), atol=ATOL)


def test_assigned_is_the_reference_list():
    assert configs.ASSIGNED == jconfigs.ASSIGNED
