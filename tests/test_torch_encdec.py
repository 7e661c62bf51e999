"""The encoder-decoder family against the reference, in float32 on the
CPU, at the smoke ``seamless-m4t-large-v2`` (2 encoder and 2 decoder
layers, d 256, 4 heads of 64, V 512, no rope) and its 2x draft,
parameters carried across by ``bridge.from_jax``:

- ``encode`` (with and without a frame mask), and one decoder layer's
  ``cross_kv`` / ``cross_attend``, against ``repro.models``';
- ``prefill`` with ``enc_embeds``: logits and every layer's self and
  cross cache; ``extend_step`` at L 1 and 5 and ``decode_step`` (ATOL, as
  tests/test_torch_model.py); the serve path against the port's
  teacher-forced logits (the reference's 2e-4, tests/test_models.py);
- ``train_loss`` and every gradient leaf, the encoder's included (the
  bounds of tests/test_torch_train.py);
- ``encoder/...``, ``cross/...`` and ``norm_x`` through ``from_jax`` /
  ``to_jax_tree`` and a checkpoint either framework loads;
  ``bridge.init_params`` fills ``norm_x`` with ones;
- ``launch.train`` feeds the audio stub's frames; ``init_cache`` and
  ``write_prefill_to_slot`` carry the cross rows;
- the refusals: the engine's ``EncoderDecoderServingError`` for an
  encoder-decoder target or draft, in fixed batch and in slots,
  ``launch.serve``'s exit 2, and the ``CloudServer`` handshake;
- the full-size parameter counts are the reference's leaf counts.
"""
import dataclasses
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core import transport as ttp  # noqa: E402
from repro_torch.core.engine import (ENCDEC_REFUSAL,  # noqa: E402
                                     EdgeCloudEngine,
                                     EncoderDecoderServingError,
                                     EngineConfig, MethodConfig)
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import frontend as tfrontend  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import net as tnet  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

from test_torch_checkpoint import _assert_same_tree, _like  # noqa: E402
from test_torch_train import (GRAD_RTOL, LOSS_ATOL,  # noqa: E402
                              _assert_tree_close, _numpy_tree)

ARCH = "seamless-m4t-large-v2"
ATOL = 1e-4
ORACLE_ATOL = 2e-4              # the reference's serve-vs-oracle bound
N_FRAMES = 8


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
    assert (jc.n_encoder_layers, jc.rope_type) == (2, "none")
    return jc, tc


def _bridged(draft, seed):
    jc, tc = _cfgs(draft)
    params = _numpy_tree(jc, seed)
    return jc, jax.tree.map(jnp.asarray, params), \
        bridge.from_jax(params, tc, device="cpu")


def _toks(rng, shape, V):
    return rng.integers(0, V, shape).astype(np.int32)


def _frames(rng, B, d, n=N_FRAMES):
    return (rng.standard_normal((B, n, d)) * 0.02).astype(np.float32)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_encode_matches_reference(masked):
    jc, jp, m = _bridged(False, 41)
    rng = np.random.default_rng(1)
    e = _frames(rng, 2, jc.d_model)
    valid = np.ones((2, N_FRAMES), bool)
    if masked:
        valid[1, 5:] = False
    ref = jencdec.encode(jc, jp["encoder"], jnp.asarray(e),
                         jnp.asarray(valid) if masked else None)
    got = tencdec.encode(m.encoder, torch.from_numpy(e),
                         torch.from_numpy(valid) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_cross_kv_and_cross_attend_match_reference():
    jc, jp, m = _bridged(False, 42)
    cp = jax.tree.map(lambda a: a[1], jp["body"]["p0"]["cross"])
    blk = m.layers[1]
    assert blk.cross.b_q is None and "b_q" not in cp
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, N_FRAMES, jc.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 5, jc.d_model)).astype(np.float32)
    valid = np.ones((2, N_FRAMES), bool)
    valid[0, 6:] = False
    rkv = jattn.cross_kv(jc, cp, jnp.asarray(enc))
    gkv = tattn.cross_kv(jc, blk.cross, torch.from_numpy(enc))
    for name in ("k", "v"):
        np.testing.assert_allclose(gkv[name].numpy(), np.asarray(rkv[name]),
                                   atol=ATOL)
    ref = jattn.cross_attend(jc, cp, jnp.asarray(x), rkv, jnp.asarray(valid))
    with torch.no_grad():
        got = tattn.cross_attend(jc, blk.cross, torch.from_numpy(x), gkv,
                                 torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("draft", [False, True], ids=["target", "draft2x"])
def test_prefill_logits_and_caches(draft):
    jc, jp, m = _bridged(draft, 43 + draft)
    rng = np.random.default_rng(3)
    toks = _toks(rng, (2, 9), jc.vocab)
    je, te = _both(_frames(rng, 2, jc.d_model))
    lj, cj = jmodel.prefill(jc, jp, jnp.asarray(toks), enc_embeds=je,
                            cache_len=24)
    lt, ct = tmodel.prefill(m, torch.from_numpy(toks).long(), cache_len=24,
                            enc_embeds=te)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    assert len(ct) == jc.n_layers
    for i, c in enumerate(ct):
        assert sorted(c) == ["cross_k", "cross_v", "k", "v"]
        for name, ref in (("k", cj["body"]["p0"]["k"]),
                          ("v", cj["body"]["p0"]["v"]),
                          ("cross_k", cj["cross"]["p0"]["k"]),
                          ("cross_v", cj["cross"]["p0"]["v"])):
            assert c[name].shape == ref[i].shape
            np.testing.assert_allclose(c[name].numpy(), np.asarray(ref[i]),
                                       atol=ATOL)


@pytest.mark.parametrize("L", [1, 5])
def test_extend_and_decode_logits(L):
    jc, jp, m = _bridged(False, 45)
    rng = np.random.default_rng(L)
    toks = _toks(rng, (3, 9), jc.vocab)
    je, te = _both(_frames(rng, 3, jc.d_model))
    _, cj = jmodel.prefill(jc, jp, jnp.asarray(toks), enc_embeds=je,
                           cache_len=32)
    _, ct = tmodel.prefill(m, torch.from_numpy(toks).long(), cache_len=32,
                           enc_embeds=te)
    cross = [(c["cross_k"].clone(), c["cross_v"].clone()) for c in ct]
    pos = np.array([9, 7, 4], np.int32)          # ragged rows
    new = _toks(rng, (3, L), jc.vocab)
    lj, cj = jmodel.extend_step(jc, jp, jnp.asarray(new), cj,
                                jnp.asarray(pos))
    lt, ct, _ = tmodel.extend_step(m, torch.from_numpy(new).long(), ct,
                                   torch.from_numpy(pos).long())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    tok = _toks(rng, (3,), jc.vocab)
    lj, _ = jmodel.decode_step(jc, jp, jnp.asarray(tok), cj,
                               jnp.asarray(pos + L))
    lt, ct = tmodel.decode_step(m, torch.from_numpy(tok).long(), ct,
                                torch.from_numpy(pos + L).long())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    for c, (k, v) in zip(ct, cross):             # read, never written
        assert torch.equal(c["cross_k"], k) and torch.equal(c["cross_v"], v)


def test_serve_path_matches_teacher_forced_logits():
    """tests/test_models.py's serve-vs-oracle check on the port, and the
    port's oracle against the reference's."""
    jc, jp, m = _bridged(False, 46)
    rng = np.random.default_rng(4)
    B, S0, S = 2, 8, 14
    toks = _toks(rng, (B, S), jc.vocab)
    je, te = _both(_frames(rng, B, jc.d_model))
    with torch.no_grad():
        full = tmodel.forward_logits(m, torch.from_numpy(toks).long(),
                                     enc_embeds=te)
    ref = jmodel.forward_logits(jc, jp, jnp.asarray(toks), enc_embeds=je)
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), atol=ATOL)
    t = torch.from_numpy(toks).long()
    lg, cache = tmodel.prefill(m, t[:, :S0], cache_len=S, enc_embeds=te)
    np.testing.assert_allclose(lg.numpy(), full[:, S0 - 1].numpy(),
                               atol=ORACLE_ATOL)
    pos = torch.full((B,), S0)
    lg, cache = tmodel.decode_step(m, t[:, S0], cache, pos)
    np.testing.assert_allclose(lg.numpy(), full[:, S0].numpy(),
                               atol=ORACLE_ATOL)
    lg3, _, _ = tmodel.extend_step(m, t[:, S0 + 1:S0 + 4], cache, pos + 1)
    np.testing.assert_allclose(lg3.numpy(), full[:, S0 + 1:S0 + 4].numpy(),
                               atol=ORACLE_ATOL)
    with pytest.raises(ValueError, match="enc_embeds"):
        tmodel.prefill(m, t[:, :S0])


def test_train_loss_and_grads_match_reference():
    jc, tc = _cfgs()
    params = _numpy_tree(jc, 11)
    rng = np.random.default_rng(7)
    toks = _toks(rng, (2, 13), jc.vocab)
    e = _frames(rng, 2, jc.d_model)

    def loss_fn(p):
        return jmodel.train_loss(jc, p, {"tokens": jnp.asarray(toks),
                                         "enc_embeds": jnp.asarray(e)})
    (rl, rmet), rg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    model = bridge.from_jax(params, tc, device="cpu", trainable=True)
    loss, met = tmodel.train_loss(model, {
        "tokens": torch.from_numpy(toks).long(),
        "enc_embeds": torch.from_numpy(e)})
    loss.backward()
    assert abs(float(loss.detach()) - float(rl)) <= LOSS_ATOL
    assert abs(float(met["ce"].detach()) - float(rmet["ce"])) <= LOSS_ATOL
    assert float(met["accuracy"]) == float(rmet["accuracy"])
    grads = bridge.to_jax_tree(model, [p.grad for p in
                                       ttrainer.parameters(model)])
    assert sorted(grads["encoder"]) == ["attn", "mlp", "norm1", "norm2"]
    assert sorted(grads["body"]["p0"]["cross"]) == ["w_k", "w_o", "w_q",
                                                    "w_v"]
    _assert_tree_close(grads, rg, GRAD_RTOL, scale_floor=1.0, what="grads")


def test_encoder_and_cross_leaves_and_checkpoints_cross_both_ways(tmp_path):
    jc, tc = _cfgs()
    params = jax.tree.map(np.asarray,
                          jmodel.init_params(jc, jax.random.PRNGKey(5)))
    model = bridge.from_jax(params, tc, device="cpu")
    paths = [path for _, path in bridge.leaves(model)]
    for path in (("encoder", "attn", "w_q", 1), ("encoder", "norm2", 0),
                 ("body", "p0", "norm_x", 1),
                 ("body", "p0", "cross", "w_o", 0)):
        assert path in paths, path
    _assert_same_tree(bridge.to_jax_tree(model), params)
    rng = np.random.default_rng(3)
    toks = _toks(rng, (2, 11), jc.vocab)
    je, te = _both(_frames(rng, 2, jc.d_model))
    ref = jmodel.forward_logits(jc, jax.tree.map(jnp.asarray, params),
                                jnp.asarray(toks), enc_embeds=je)
    # the reference's checkpoint in the port
    path = os.path.join(tmp_path, "ref.npz")
    jckpt.save(path, params)
    loaded = bridge.from_jax(tckpt.load(path), tc, device="cpu")
    with torch.no_grad():
        got = tmodel.forward_logits(loaded, torch.from_numpy(toks).long(),
                                    enc_embeds=te)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    # a port model's checkpoint in the reference
    seeded = bridge.seeded_model(tc, 4, "cpu", trainable=True)
    path = os.path.join(tmp_path, "port")
    tckpt.save(path, bridge.to_jax_tree(seeded), meta={"arch": tc.name})
    back = jckpt.load(path, like=_like(jc))
    _assert_same_tree(back, bridge.to_jax_tree(seeded))
    ref = jmodel.forward_logits(jc, back, jnp.asarray(toks), enc_embeds=je)
    with torch.no_grad():
        got = tmodel.forward_logits(seeded, torch.from_numpy(toks).long(),
                                    enc_embeds=te)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_init_params_fills_norm_x_with_ones():
    """``bridge.init_params`` gives the norms (norm_x among them) the
    reference's ones, and each random leaf (the encoder's and the
    cross-attention's among them) the reference's 1/sqrt(fan_in) within
    20%."""
    jc, tc = _cfgs()
    ref = jax.tree.map(np.asarray,
                       jmodel.init_params(jc, jax.random.PRNGKey(0)))
    got = bridge.to_jax_tree(bridge.init_params(
        tc, torch.Generator().manual_seed(0), device="cpu"))
    flat_r = {jax.tree_util.keystr(p): r for p, r in
              jax.tree_util.tree_leaves_with_path(ref)}
    flat_g = {jax.tree_util.keystr(p): g for p, g in
              jax.tree_util.tree_leaves_with_path(got)}
    assert sorted(flat_r) == sorted(flat_g)
    norms = [key for key in flat_g if "norm" in key]
    assert "['body']['p0']['norm_x']" in norms and len(norms) == 6
    for key, g in flat_g.items():
        r = flat_r[key]
        assert g.shape == r.shape, key
        if key in norms:
            np.testing.assert_array_equal(g, r, err_msg=key)
            np.testing.assert_array_equal(g, np.ones_like(g), err_msg=key)
        else:
            ratio = float(g.std()) / float(r.std())
            assert abs(ratio - 1.0) < 0.2, (key, ratio)


def test_train_launcher_feeds_the_audio_frames(tmp_path):
    """``launch.train`` trains on 32 stub frames a row drawn from the step
    index: its first loss is ``train_loss`` of the seeded model on the
    first batch and those frames, and its checkpoint loads in the
    reference."""
    from repro_torch.launch import train as ttrain
    jc, tc = _cfgs()
    out = os.path.join(tmp_path, "encdec")
    hist = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "12",
                        "--log-every", "1", "--out", out])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    data = SyntheticLM(DataConfig(vocab=tc.vocab, seq_len=12, batch=2,
                                  seed=1234))
    b = next(iter(data.batches(1)))
    frames = tfrontend.audio_frame_embeds(torch.Generator().manual_seed(0),
                                          2, 32, tc.d_model)
    assert frames.shape == (2, 32, tc.d_model)
    assert abs(float(frames.std()) - 0.02) < 0.002
    with torch.no_grad():
        loss, _ = tmodel.train_loss(
            bridge.seeded_model(tc, 0, "cpu", trainable=True),
            {"tokens": torch.from_numpy(b["tokens"]), "enc_embeds": frames})
    assert float(loss) == pytest.approx(hist[0]["loss"], abs=1e-6)
    _assert_same_tree(jckpt.load(out, like=_like(jc)), tckpt.load(out))


def test_init_cache_and_write_prefill_to_slot_carry_the_cross_rows():
    _, _, m = _bridged(False, 47)
    prompt = torch.arange(1, 7)[None]
    frames = tfrontend.audio_frame_embeds(torch.Generator().manual_seed(1),
                                          1, N_FRAMES, m.cfg.d_model)
    _, small = tmodel.prefill(m, prompt, cache_len=16, enc_embeds=frames)
    for paged in (None, tattn.PagedSpec(page_size=8, n_pages=4,
                                        max_pages_per_slot=2)):
        cache = tmodel.init_cache(m, 2, 16, paged=paged, enc_seq=N_FRAMES)
        assert all(c["cross_k"].shape == (2, N_FRAMES, 4, 64) for c in cache)
        before = [dict(c) for c in cache]
        pt_row = None if paged is None else torch.tensor([0, 1])
        tmodel.write_prefill_to_slot(m.cfg, cache, small, 1, pt_row, 6)
        for c, b, s in zip(cache, before, small):
            for name in ("cross_k", "cross_v"):
                assert c[name] is b[name]               # in place
                assert torch.equal(c[name][1], s[name][0])
                assert not c[name][0].any()
            if paged is not None:
                assert torch.equal(c["k"][0, :6], s["k"][0, :6])


def _decoder_only(cfg):
    """A decoder-only config of ``cfg``'s widths and vocabulary."""
    return dataclasses.replace(cfg, name=cfg.name + "-decoder",
                               family="dense", n_encoder_layers=0,
                               frontend="none")


@pytest.mark.parametrize("side", ["target", "draft"])
def test_engine_refuses_encoder_decoder_models(side):
    _, tc = _cfgs()
    dc = configs.draft_variant(tc, 2)
    if side == "target":
        dc = _decoder_only(dc)
    else:
        tc = _decoder_only(tc)
    tm, dm = (bridge.seeded_model(c, s, "cpu") for c, s in ((tc, 1),
                                                           (dc, 2)))
    eng = EdgeCloudEngine(dc, dm, tc, tm, MethodConfig("ksqs", K=8),
                          EngineConfig(L_max=3), seed=0, device="cpu")
    actor = eng.cloud if side == "target" else eng.edge
    refused = tc if side == "target" else dc
    for call in (lambda: eng.run(np.zeros((2, 8), np.int64), 1),
                 lambda: eng.init_slots(2, 32),
                 lambda: actor.prefill_batch(torch.zeros((2, 8),
                                                         dtype=torch.int64),
                                             32),
                 lambda: actor.init_slots(2, 32, None)):
        with pytest.raises(EncoderDecoderServingError) as e:
            call()
        assert str(e.value) == f"{refused.name}: {ENCDEC_REFUSAL}"


def test_serve_cli_refuses_encoder_decoder_before_building(capsys,
                                                           monkeypatch):
    from repro_torch.launch import serve as tlaunch
    monkeypatch.setattr(tlaunch, "load_or_init", None)
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--rounds", "1"])
    assert e.value.code == 2
    assert f"{ARCH}: {ENCDEC_REFUSAL}" in capsys.readouterr().err


def test_cloud_server_refuses_encoder_decoder_target():
    method, ecfg = MethodConfig("csqs"), EngineConfig(L_max=3)
    built = []
    server = tnet.CloudServer(
        device="cpu", build_target=lambda *a: built.append(a)).start()
    try:
        sock = socket.create_connection(("127.0.0.1", server.port),
                                        timeout=30)
        conn = ttp.Conn(sock, timeout_s=30)
        try:
            conn.send_json(ttp.MSG_HELLO, {
                "proto": ttp.PROTO_VERSION, "session": "encdec", "cell": 0,
                "n_cells": 1, "config": tnet.engine_digest(
                    ARCH, True, method, ecfg, 0, 2, 32, False)})
            with pytest.raises(ttp.TransportError) as e:
                conn.recv_expect(ttp.MSG_HELLO_OK)
        finally:
            conn.close()
    finally:
        server.stop()
    assert str(e.value) == f"peer error: bad config: {ARCH}-smoke: " \
        f"{ENCDEC_REFUSAL}"
    assert built == []                          # refused before the build


def test_full_size_param_counts_are_the_reference_leaf_counts():
    for cfg, n in ((configs.get_config(ARCH), 2_034_783_232),
                   (configs.draft_variant(configs.get_config(ARCH), 2),
                    451_129_856)):
        assert tmodel.param_count(tmodel.Transformer(cfg,
                                                     device="meta")) == n
