"""M-RoPE and the vision frontend stub against the reference, in float32
on the CPU, at the smoke ``qwen2-vl-72b`` (2 layers, d 256, 4 query heads
and 1 KV head of 64, sections (8, 12, 12), qkv biases) and its 2x draft,
parameters carried across by ``bridge.from_jax``:

- ``apply_mrope`` on random (3, B, S) ids; text-only (B, S) positions
  give plain RoPE bit for bit;
- ``frontend.vision_patch_positions`` / ``mrope_text_positions`` equal
  the reference's integer maps;
- prefill at a vision patch grid's positions then text, then decode and
  a 5-token extend at the default positions: logits and caches (ATOL, as
  tests/test_torch_model.py), and the serve path against the port's
  teacher-forced logits at the same positions (the reference's 2e-4);
- ``forward_logits`` and ``train_loss`` (and its gradients) with
  ``batch["positions"]``; the trainer refuses to split (3, B, S) ids
  into microbatches;
- fixed-batch K-SQS and C-SQS streams (every integer field and wire byte
  equal, C-SQS beta within the pinned ulps) and one C-SQS trace served
  dense and paged, each the reference's streams and
  ``ServeReport.summary()``;
- the full-size parameter counts are the reference's leaf counts.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import frontend as jfrontend  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.models import frontend as tfrontend  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, init_state  # noqa: E402

import test_torch_stateful_engine as st  # noqa: E402
from test_torch_train import (GRAD_RTOL, LOSS_ATOL,  # noqa: E402
                              _assert_tree_close, _numpy_tree)

ARCH = "qwen2-vl-72b"
ATOL = 1e-4
ORACLE_ATOL = 2e-4              # the reference's serve-vs-oracle bound
# the divergence measured at these seeds, per round: the largest ulp
# distance of (a payload's beta, a verdict's beta); K-SQS is byte-equal
ULPS = {"csqs": [(1, 1), (1, 1), (1, 1)]}
GRID_H, GRID_W, N_PATCH, N_TEXT = 3, 4, 12, 6


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
    assert (jc.rope_type, jc.mrope_sections, jc.qkv_bias,
            jc.n_kv_heads) == ("mrope", (8, 12, 12), True, 1)
    return jc, tc


def _bridged(draft, seed):
    jc, tc = _cfgs(draft)
    params = _numpy_tree(jc, seed)
    return jc, jax.tree.map(jnp.asarray, params), \
        bridge.from_jax(params, tc, device="cpu")


def _toks(rng, shape, V):
    return rng.integers(0, V, shape).astype(np.int32)


def _vision_positions(B):
    """A patch grid's (t, h, w) ids, then text from N_PATCH on."""
    return np.concatenate(
        [np.asarray(jfrontend.vision_patch_positions(B, N_PATCH, GRID_H,
                                                     GRID_W)),
         np.asarray(jfrontend.mrope_text_positions(B, N_TEXT,
                                                   start=N_PATCH))],
        axis=-1).astype(np.int32)


def test_apply_mrope_matches_reference():
    jc, _ = _cfgs()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, jc.head_dim)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 2, 7)).astype(np.int32)
    ref = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                              jc.mrope_sections, jc.rope_theta)
    got = tlayers.apply_mrope(torch.from_numpy(x),
                              torch.from_numpy(pos).long(),
                              jc.mrope_sections, jc.rope_theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_text_only_mrope_is_plain_rope():
    jc, tc = _cfgs()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(
        (2, 7, 4, tc.head_dim)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 5000, (2, 7))).long()
    got = tlayers.rope_apply_by_cfg(tc, x, pos)
    assert torch.equal(got, tlayers.apply_rope(x, pos, tc.rope_theta))
    assert torch.equal(got, tlayers.apply_mrope(
        x, pos[None].expand(3, 2, 7), tc.mrope_sections, tc.rope_theta))
    ref = jlayers.rope_apply_by_cfg(jc, jnp.asarray(x.numpy()),
                                    jnp.asarray(pos.numpy(), jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("B,n,gh,gw,start", [(2, 12, 3, 4, 0),
                                             (3, 40, 5, 6, 7)])
def test_frontend_positions_equal_reference(B, n, gh, gw, start):
    got = tfrontend.vision_patch_positions(B, n, gh, gw, device="cpu")
    ref = np.asarray(jfrontend.vision_patch_positions(B, n, gh, gw))
    assert got.shape == ref.shape == (3, B, n)
    np.testing.assert_array_equal(got.numpy(), ref)
    got = tfrontend.mrope_text_positions(B, n, start=start, device="cpu")
    ref = np.asarray(jfrontend.mrope_text_positions(B, n, start=start))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("draft", [False, True], ids=["target", "draft2x"])
def test_vision_prefill_then_decode_and_extend(draft):
    jc, jp, m = _bridged(draft, 31 + draft)
    rng = np.random.default_rng(5)
    S0 = N_PATCH + N_TEXT
    toks = _toks(rng, (2, S0 + 6), jc.vocab)
    pos3 = _vision_positions(2)
    lj, cj = jmodel.prefill(jc, jp, jnp.asarray(toks[:, :S0]),
                            positions=jnp.asarray(pos3), cache_len=32)
    lt, ct = tmodel.prefill(m, torch.from_numpy(toks[:, :S0]).long(),
                            cache_len=32,
                            positions=torch.from_numpy(pos3).long())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    for i, c in enumerate(ct):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                c[name].numpy(), np.asarray(cj["body"]["p0"][name][i]),
                atol=ATOL)
    pos = np.full((2,), S0, np.int32)
    lj, cj = jmodel.decode_step(jc, jp, jnp.asarray(toks[:, S0]), cj,
                                jnp.asarray(pos))
    lt, ct = tmodel.decode_step(m, torch.from_numpy(toks[:, S0]).long(), ct,
                                torch.from_numpy(pos).long())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    new = toks[:, S0 + 1:S0 + 6]
    lj5, _ = jmodel.extend_step(jc, jp, jnp.asarray(new), cj,
                                jnp.asarray(pos + 1))
    lt5, _, _ = tmodel.extend_step(m, torch.from_numpy(new).long(), ct,
                                   torch.from_numpy(pos + 1).long())
    np.testing.assert_allclose(lt5.numpy(), np.asarray(lj5), atol=ATOL)
    # the serve path against the teacher-forced logits of the same tokens,
    # the decoded ones at t == h == w == their index
    tail = np.broadcast_to(np.arange(S0, S0 + 6, dtype=np.int32),
                           (3, 2, 6))
    full_pos = torch.from_numpy(np.concatenate([pos3, tail], -1)).long()
    with torch.no_grad():
        full = tmodel.forward_logits(m, torch.from_numpy(toks).long(),
                                     positions=full_pos)
    np.testing.assert_allclose(lt.numpy(), full[:, S0].numpy(),
                               atol=ORACLE_ATOL)
    np.testing.assert_allclose(lt5.numpy(), full[:, S0 + 1:].numpy(),
                               atol=ORACLE_ATOL)


def test_forward_logits_and_train_loss_with_positions():
    jc, tc = _cfgs()
    params = _numpy_tree(jc, 12)
    rng = np.random.default_rng(7)
    S = N_PATCH + N_TEXT
    toks = _toks(rng, (2, S + 1), jc.vocab)
    pos3 = _vision_positions(2)
    ref = jmodel.forward_logits(jc, jax.tree.map(jnp.asarray, params),
                                jnp.asarray(toks[:, :S]),
                                positions=jnp.asarray(pos3))
    model = bridge.from_jax(params, tc, device="cpu", trainable=True)
    with torch.no_grad():
        got = tmodel.forward_logits(model,
                                    torch.from_numpy(toks[:, :S]).long(),
                                    positions=torch.from_numpy(pos3).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    # the vision positions change the logits: they reach the rotation
    with torch.no_grad():
        text = tmodel.forward_logits(model,
                                     torch.from_numpy(toks[:, :S]).long())
    assert float((text - got).abs().max()) > 1e-2

    def loss_fn(p):
        return jmodel.train_loss(jc, p, {"tokens": jnp.asarray(toks),
                                         "positions": jnp.asarray(pos3)})
    (rl, rmet), rg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    loss, met = tmodel.train_loss(model, {
        "tokens": torch.from_numpy(toks).long(),
        "positions": torch.from_numpy(pos3).long()})
    loss.backward()
    assert abs(float(loss.detach()) - float(rl)) <= LOSS_ATOL
    assert float(met["accuracy"]) == float(rmet["accuracy"])
    grads = bridge.to_jax_tree(model, [p.grad for p in
                                       ttrainer.parameters(model)])
    _assert_tree_close(grads, rg, GRAD_RTOL, scale_floor=1.0, what="grads")


def test_frontend_positions_default_to_the_card():
    """Like every entry point of the port, the position helpers run on
    the card unless asked for the CPU: without one, a call that does not
    name a device raises."""
    if torch.cuda.is_available():
        got = tfrontend.mrope_text_positions(2, 12)
        assert got.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA requested"):
        tfrontend.vision_patch_positions(2, 12, 3, 4)
    with pytest.raises(RuntimeError, match="CUDA requested"):
        tfrontend.mrope_text_positions(2, 12)


def test_trainer_refuses_to_split_3d_positions():
    _, tc = _cfgs(draft=True)
    model = bridge.seeded_model(tc, 0, "cpu", trainable=True)
    toks = torch.randint(0, tc.vocab, (4, 9),
                         generator=torch.Generator().manual_seed(0))
    pos3 = tfrontend.mrope_text_positions(4, 8, device="cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    state = init_state(ttrainer.parameters(model))
    step2 = ttrainer.make_train_step(tc, opt, microbatches=2)
    with pytest.raises(ValueError, match="microbatches"):
        step2(model, state, {"tokens": toks, "positions": pos3})
    # one microbatch takes them, and (B, S) positions still split
    step1 = ttrainer.make_train_step(tc, opt, microbatches=1)
    _, state, m1 = step1(model, state, {"tokens": toks, "positions": pos3})
    _, _, m2 = step2(model, state, {"tokens": toks,
                                    "positions": pos3[0].clone()})
    assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m2["loss"]))


@pytest.mark.parametrize("method", ["ksqs", "csqs"])
def test_engine_matches_reference(method):
    st.check_engine_matches_reference(ARCH, method, ULPS)


def test_trace_dense_and_paged_match_reference():
    dense = st.streams(st.serve_both(ARCH))
    paged = st.serve_both(ARCH, page_size=8)
    assert dense == st.streams(paged)
    assert paged.peak_pages_in_use > 0


def test_full_size_param_counts_are_the_reference_leaf_counts():
    for cfg, n in ((configs.get_config(ARCH), 72_706_203_648),
                   (configs.draft_variant(configs.get_config(ARCH), 2),
                    10_159_181_824)):
        assert tmodel.param_count(tmodel.Transformer(cfg,
                                                     device="meta")) == n
