"""Multi-head latent attention and the dense prefix layer against the
reference, in float32 on the CPU, at the smoke ``deepseek-v2-lite-16b``
(3 layers, the first a dense prefix layer; kv_lora 64, rope_hd 32, v_hd
64, 4 experts) and its 2x draft, parameters carried across by
``bridge.from_jax``:

- ``mla_full`` (train and prefill, the latent expanded) and
  ``mla_extend`` (decode and verify, W_uk absorbed into the query) of one
  layer against ``repro.models.attention``'s, and the whole model's
  prefill cache, extend (L 1 and 5) and decode logits (ATOL, as
  tests/test_torch_model.py);
- the absorbed extend against the expanded path on the same tokens (the
  reference's serve-vs-oracle test, tests/test_models.py);
- ``train_loss`` and its gradients through the prefix (the bounds of
  tests/test_torch_train.py);
- ``prefix/l0/...`` leaves through ``from_jax`` / ``to_jax_tree`` and a
  checkpoint either framework loads;
- the fixed-batch engine's streams in all four methods (every integer
  field and wire byte equal, C-SQS beta within the pinned ulps);
- a trace served dense lockstep, paged lockstep and paged pipelined,
  each equal to the reference's streams and ``ServeReport.summary()``,
  and to each other;
- the MLA cache stays in the compute dtype under an int8 KV setting,
  ``write_prefill_to_slot`` writes an MLA layer's cache in place, and the
  full-size parameter counts are the reference's leaf counts.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

import test_torch_stateful_engine as st  # noqa: E402
from test_torch_checkpoint import _assert_same_tree, _like  # noqa: E402
from test_torch_train import (GRAD_RTOL, LOSS_ATOL,  # noqa: E402
                              _assert_tree_close, _numpy_tree)

ARCH = "deepseek-v2-lite-16b"
ATOL = 1e-4
ORACLE_ATOL = 2e-4              # the reference's serve-vs-oracle bound
# the divergence measured at these seeds, per round: the largest ulp
# distance of (a payload's float field, a verdict's beta) -- C-SQS's beta
# (inside the 22 of tests/test_torch_engine.py) and the uncompressed
# payloads' raw probabilities, each a float32 softmax of logits the two
# frameworks sum in different orders; every case not listed is byte-equal
ULPS = {"csqs": [(1, 1), (3, 3), (6, 3)],
        "uncompressed": [(52, 0), (41, 0), (45, 0)]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(draft=False):
    jc = jconfigs.smoke_variant(jconfigs.get_config(ARCH))
    tc = configs.smoke_variant(configs.get_config(ARCH))
    if draft:
        jc, tc = jconfigs.draft_variant(jc, 2), configs.draft_variant(tc, 2)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _toks(rng, shape, V):
    return rng.integers(0, V, shape).astype(np.int32)


def _layer(seed):
    """One MLA layer's reference parameters and the port's module."""
    jc, tc = _cfgs()
    p = jax.tree.map(np.asarray, jattn.init_attn(jax.random.PRNGKey(seed),
                                                 jc))
    m = tattn.MLA(tc, torch.float32, "cpu")
    with torch.no_grad():
        for name in bridge.MLA_LEAVES:
            getattr(m, name).copy_(torch.from_numpy(p[name]))
    x = np.random.default_rng(seed).standard_normal(
        (2, 7, jc.d_model)).astype(np.float32)
    return jc, tc, jax.tree.map(jnp.asarray, p), m, x


def test_mla_full_and_extend_match_reference():
    jc, tc, jp, m, x = _layer(1)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    ref, rc = jattn.mla_full(jc, jp, jnp.asarray(x), jnp.asarray(pos),
                             return_cache=True)
    got, gc = tattn.mla_full(tc, m, torch.from_numpy(x),
                             torch.from_numpy(pos).long(), return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    for name in ("latent", "k_rope"):
        np.testing.assert_allclose(gc[name].numpy(), np.asarray(rc[name]),
                                   atol=ATOL)
    # extend L = 3 new tokens at ragged positions over a 12-slot cache
    cache = {name: np.zeros((2, 12) + rc[name].shape[2:], np.float32)
             for name in rc}
    for name in cache:
        cache[name][:, :7] = np.asarray(rc[name])
    start = np.array([7, 4], np.int32)
    new = np.random.default_rng(2).standard_normal(
        (2, 3, jc.d_model)).astype(np.float32)
    npos = start[:, None] + np.arange(3, dtype=np.int32)
    ref, rc2 = jattn.mla_extend(jc, jp, jnp.asarray(new), jnp.asarray(npos),
                                jax.tree.map(jnp.asarray, cache),
                                jnp.asarray(start))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, gc2 = tattn.mla_extend(tc, m, torch.from_numpy(new),
                                torch.from_numpy(npos).long(), tcache,
                                torch.from_numpy(start).long())
    assert gc2 is tcache                        # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    for name in ("latent", "k_rope"):
        np.testing.assert_allclose(gc2[name].numpy(), np.asarray(rc2[name]),
                                   atol=ATOL)


def _bridged(draft, seed):
    jc, tc = _cfgs(draft)
    params = _numpy_tree(jc, seed)
    return jc, jax.tree.map(jnp.asarray, params), \
        bridge.from_jax(params, tc, device="cpu")


@pytest.mark.parametrize("L", [1, 5])
@pytest.mark.parametrize("draft", [False, True], ids=["target", "draft2x"])
def test_prefill_extend_decode_logits(draft, L):
    jc, jp, m = _bridged(draft, 21 + draft)
    assert [blk.ffn_type for blk in m.layers][:2] == ["mlp", "moe"]
    rng = np.random.default_rng(L)
    toks = _toks(rng, (3, 9), jc.vocab)
    lj, cj = jmodel.prefill(jc, jp, jnp.asarray(toks), cache_len=32)
    lt, ct = tmodel.prefill(m, torch.from_numpy(toks).long(), cache_len=32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    refs = [cj["prefix"]["l0"]] + [
        jax.tree.map(lambda a, i=i: a[i], cj["body"]["p0"])
        for i in range(jc.n_periods)]
    for c, r in zip(ct, refs):
        assert sorted(c) == ["k_rope", "latent"]
        for name, t in c.items():
            assert t.shape == r[name].shape == (3, 32, t.shape[-1])
            np.testing.assert_allclose(t.numpy(), np.asarray(r[name]),
                                       atol=ATOL)
    pos = np.array([9, 7, 4], np.int32)
    new = _toks(rng, (3, L), jc.vocab)
    lj, cj = jmodel.extend_step(jc, jp, jnp.asarray(new), cj,
                                jnp.asarray(pos))
    lt, ct, _ = tmodel.extend_step(m, torch.from_numpy(new).long(), ct,
                                   torch.from_numpy(pos).long())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    tok = _toks(rng, (3,), jc.vocab)
    lj, _ = jmodel.decode_step(jc, jp, jnp.asarray(tok), cj,
                               jnp.asarray(pos + L))
    lt, _ = tmodel.decode_step(m, torch.from_numpy(tok).long(), ct,
                               torch.from_numpy(pos + L).long())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)


def test_absorbed_extend_matches_expanded_path():
    """The reference's serve-vs-oracle test on the port: prefill (the
    latent expanded), one absorbed decode step and an absorbed 3-token
    extend give the teacher-forced logits of the expanded path."""
    _, _, m = _bridged(False, 23)
    toks = torch.from_numpy(_toks(np.random.default_rng(4), (2, 14),
                                  m.cfg.vocab)).long()
    with torch.no_grad():
        full = tmodel.forward_logits(m, toks)
    lg, cache = tmodel.prefill(m, toks[:, :8], cache_len=14)
    np.testing.assert_allclose(lg.numpy(), full[:, 7].numpy(),
                               atol=ORACLE_ATOL)
    pos = torch.full((2,), 8)
    lg, cache = tmodel.decode_step(m, toks[:, 8], cache, pos)
    np.testing.assert_allclose(lg.numpy(), full[:, 8].numpy(),
                               atol=ORACLE_ATOL)
    lg3, _, _ = tmodel.extend_step(m, toks[:, 9:12], cache, pos + 1)
    np.testing.assert_allclose(lg3.numpy(), full[:, 9:12].numpy(),
                               atol=ORACLE_ATOL)


def test_train_loss_and_grads_match_reference():
    jc, tc = _cfgs()
    params = _numpy_tree(jc, 11)
    toks = _toks(np.random.default_rng(7), (2, 17), jc.vocab)

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
    assert sorted(grads["prefix"]["l0"]["attn"]) == sorted(bridge.MLA_LEAVES)
    _assert_tree_close(grads, rg, GRAD_RTOL, scale_floor=1.0, what="grads")
    # the prefix's leaves are unstacked in the reference: not decayed
    mask = dict(zip([path for _, path in bridge.leaves(model)],
                    ttrainer.decay_mask(model)))
    assert mask[("prefix", "l0", "norm1")] is False
    assert mask[("prefix", "l0", "attn", "w_uk")] is True
    assert mask[("body", "p0", "norm1", 0)] is True


def test_prefix_leaves_and_checkpoints_cross_both_ways(tmp_path):
    jc, tc = _cfgs()
    params = jax.tree.map(np.asarray,
                          jmodel.init_params(jc, jax.random.PRNGKey(5)))
    model = bridge.from_jax(params, tc, device="cpu")
    paths = [path for _, path in bridge.leaves(model)]
    assert ("prefix", "l0", "mlp", "w_gate") in paths
    assert ("body", "p0", "attn", "w_krope", 1) in paths
    _assert_same_tree(bridge.to_jax_tree(model), params)
    toks = _toks(np.random.default_rng(3), (2, 11), jc.vocab)
    ref = jmodel.forward_logits(jc, jax.tree.map(jnp.asarray, params),
                                jnp.asarray(toks))
    # the reference's checkpoint in the port
    path = os.path.join(tmp_path, "ref.npz")
    jckpt.save(path, params)
    loaded = bridge.from_jax(tckpt.load(path), tc, device="cpu")
    with torch.no_grad():
        got = tmodel.forward_logits(loaded, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    # a port model's checkpoint in the reference
    seeded = bridge.seeded_model(tc, 4, "cpu", trainable=True)
    path = os.path.join(tmp_path, "port")
    tckpt.save(path, bridge.to_jax_tree(seeded), meta={"arch": tc.name})
    back = jckpt.load(path, like=_like(jc))
    _assert_same_tree(back, bridge.to_jax_tree(seeded))
    ref = jmodel.forward_logits(jc, back, jnp.asarray(toks))
    with torch.no_grad():
        got = tmodel.forward_logits(seeded, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_init_params_mla_fan_ins():
    """``bridge.init_params`` draws each MLA leaf at 1/sqrt(the fan-in the
    reference's ``init_attn`` passes): d for w_q, w_dkv and w_krope, the
    rank for w_uk and w_uv, nq * v_hd for w_o."""
    _, tc = _cfgs()
    m = bridge.init_params(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    a = m.layers[1].attn
    d, rank = tc.d_model, tc.kv_lora_rank
    fans = {"w_q": d, "w_dkv": d, "w_krope": d, "w_uk": rank, "w_uv": rank,
            "w_o": tc.n_heads * tc.v_hd}
    for name, fan in fans.items():
        std = float(getattr(a, name).std())
        assert abs(std * np.sqrt(fan) - 1.0) < 0.1, (name, std)


@pytest.mark.parametrize("method", ["ksqs", "csqs", "qs", "uncompressed"])
def test_engine_matches_reference(method):
    st.check_engine_matches_reference(ARCH, method, ULPS)


def test_trace_dense_paged_pipelined_match_reference():
    """Dense lockstep, paged lockstep and paged pipelined: each the
    reference's streams and summary, and the same streams (MLA layers stay
    dense under a paged session, as the reference's)."""
    dense = st.streams(st.serve_both(ARCH))
    paged = st.serve_both(ARCH, page_size=8)
    pipe = st.serve_both(ARCH, page_size=8, pipeline="pipelined")
    assert dense == st.streams(paged) == st.streams(pipe)
    assert paged.peak_pages_in_use > 0


def test_int8_kv_setting_keeps_the_latent_cache_in_the_compute_dtype():
    """``kv_cache_dtype="int8"`` leaves MLA caches in the compute dtype,
    as the reference's ``make_kv_cache``: the same cache and logits."""
    _, _, m = _bridged(False, 21)
    m8 = tmodel.Transformer(dataclasses.replace(m.cfg,
                                                kv_cache_dtype="int8"),
                            device="cpu")
    m8.load_state_dict(m.state_dict())
    toks = torch.arange(3, 12)[None]
    (la, ca), (lb, cb) = (tmodel.prefill(x, toks, cache_len=12)
                          for x in (m, m8))
    assert torch.equal(la, lb)
    for a, b in zip(ca, cb):
        assert all(torch.equal(a[k], b[k]) and b[k].dtype == torch.float32
                   for k in a)
    assert all(c["latent"].dtype == torch.float32
               for c in tmodel.init_cache(m8, 2, 12))


def test_write_prefill_to_slot_writes_mla_in_place():
    _, (_, _, tc, tm) = st.pair(ARCH)
    cache = tmodel.init_cache(tm, 2, 16, paged=tattn.PagedSpec(
        page_size=8, n_pages=4, max_pages_per_slot=2))
    assert not any("page_table" in c for c in cache)
    before = [{name: t for name, t in c.items()} for c in cache]
    prompt = torch.arange(1, 7)[None]
    _, small = tmodel.prefill(tm, prompt, cache_len=16)
    tmodel.write_prefill_to_slot(tc, cache, small, 1)
    for c, b, s in zip(cache, before, small):
        for name, t in c.items():
            assert t is b[name], name
            assert torch.equal(t[1], s[name][0])
            assert not t[0].any()


def test_full_size_param_counts_are_the_reference_leaf_counts():
    for cfg, n in ((configs.get_config(ARCH), 15_706_470_400),
                   (configs.draft_variant(configs.get_config(ARCH), 2),
                    2_131_325_952)):
        assert tmodel.param_count(tmodel.Transformer(cfg,
                                                     device="meta")) == n
