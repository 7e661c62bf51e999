"""The port's serving caches on bridged smoke parameters: the paged pool
gives bit-for-bit the dense cache's logits (both layouts run one
``_extend_core`` over the same masked width), in float32, bf16 and int8;
and the paged and int8 caches agree with repro.models' (jitted, as the
reference engine runs them) to atol 1e-4 in float32 -- torch and XLA
reduce in different orders, as in test_torch_model.py."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.pages import PageAllocator as RefAllocator  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core.pages import PageAllocator  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

ATOL = 1e-4
B, CACHE, PS = 3, 32, 8
MAXP = CACHE // PS
N_PAGES = 10
PROMPTS = (11, 6, 9)        # slot 2 is released again before the step


def _cfgs(variant):
    jt = jconfigs.smoke_variant(jconfigs.get_config("qwen2.5-3b"))
    tt = configs.smoke_variant(configs.get_config("qwen2.5-3b"))
    kw = {"f32": {}, "bf16": {"dtype": "bfloat16"},
          "int8": {"kv_cache_dtype": "int8"}}[variant]
    return dataclasses.replace(jt, **kw), dataclasses.replace(tt, **kw)


@functools.lru_cache(maxsize=None)
def _params(seed=3):
    jt, _ = _cfgs("f32")
    shapes = jax.eval_shape(lambda k: jmodel.init_params(jt, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if "norm" in jax.tree_util.keystr(path):
            return np.ones(s.shape, np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _prompts(V):
    rng = np.random.default_rng(5)
    return [rng.integers(0, V, n).astype(np.int64) for n in PROMPTS]


def _serve_cache(model, paged: bool, prompts, L: int):
    """A 3-slot cache with each prompt admitted (slot 2 then released)
    and the slots grown for an L-token step; returns (cache, pos)."""
    spec = tattn.PagedSpec(PS, N_PAGES, MAXP) if paged else None
    cache = tmodel.init_cache(model, B, CACHE, paged=spec)
    alloc = PageAllocator(N_PAGES, PS, B, MAXP)
    pos = []
    for slot, p in enumerate(prompts):
        _, small = tmodel.prefill(model, torch.from_numpy(p[None, :-1]),
                                  cache_len=CACHE)
        pt_row = None
        if paged:
            assert alloc.admit(slot, len(p) - 1)
            pt_row = tattn.sanitize_page_table(alloc.table, N_PAGES,
                                               "cpu")[slot]
        tmodel.write_prefill_to_slot(model.cfg, cache, small, slot, pt_row,
                                     len(p) - 1)
        pos.append(len(p) - 1)
    alloc.release(2)
    for slot in (0, 1):
        assert alloc.ensure(slot, pos[slot] + L)
    if paged:
        tmodel.set_page_tables(cache, tattn.sanitize_page_table(
            alloc.table, N_PAGES, "cpu"))
    return cache, torch.tensor(pos)


@pytest.mark.parametrize("variant", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("L", [1, 5])
def test_paged_equals_dense_bitwise(variant, L):
    _, tcfg = _cfgs(variant)
    model = bridge.from_jax(_params(), tcfg, device="cpu")
    prompts = _prompts(tcfg.vocab)
    rng = np.random.default_rng(L)
    out = {}
    for paged in (False, True):
        cache, pos = _serve_cache(model, paged, prompts, 2 * L)
        steps = []
        for _ in range(2):                       # second step reads the first
            toks = torch.from_numpy(rng.integers(0, tcfg.vocab, (B, L)))
            logits, cache, _ = tmodel.extend_step(model, toks, cache, pos)
            steps.append(logits[:2])             # slot 2: trash page
            pos = pos + L
        out[paged] = torch.stack(steps)
        rng = np.random.default_rng(L)
    assert out[True].dtype == torch.float32
    assert torch.isfinite(out[True]).all()
    assert torch.equal(out[False], out[True])


def _ref_serve_cache(jcfg, params, paged: bool, prompts, L: int):
    spec = jattn.PagedSpec(PS, N_PAGES, MAXP) if paged else None
    cache = jmodel.init_cache(jcfg, B, CACHE, paged=spec)
    alloc = RefAllocator(N_PAGES, PS, B, MAXP)
    pre = jax.jit(functools.partial(jmodel.prefill, jcfg, cache_len=CACHE))
    pos = []
    for slot, p in enumerate(prompts):
        _, small = pre(params, jnp.asarray(p[None, :-1], jnp.int32))
        pt_row = None
        if paged:
            assert alloc.admit(slot, len(p) - 1)
            pt_row = jattn.sanitize_page_table(alloc.table, N_PAGES)[slot]
        cache = jmodel.write_prefill_to_slot(jcfg, cache, small, slot, pt_row,
                                             len(p) - 1)
        pos.append(len(p) - 1)
    alloc.release(2)
    for slot in (0, 1):
        assert alloc.ensure(slot, pos[slot] + L)
    if paged:
        cache = jmodel.set_page_tables(
            cache, jattn.sanitize_page_table(alloc.table, N_PAGES))
    return cache, jnp.asarray(pos, jnp.int32)


@pytest.mark.parametrize("variant,paged", [("f32", True), ("int8", False),
                                           ("int8", True)])
def test_serving_cache_logits_vs_reference(variant, paged):
    jcfg, tcfg = _cfgs(variant)
    params = _params()
    jp = jax.tree.map(jnp.asarray, params)
    model = bridge.from_jax(params, tcfg, device="cpu")
    prompts = _prompts(tcfg.vocab)
    L = 4
    cj, pj = _ref_serve_cache(jcfg, jp, paged, prompts, 2 * L)
    ct, pt = _serve_cache(model, paged, prompts, 2 * L)
    ext = jax.jit(functools.partial(jmodel.extend_step, jcfg))
    rng = np.random.default_rng(9)
    for _ in range(2):
        toks = rng.integers(0, tcfg.vocab, (B, L))
        lj, cj = ext(jp, jnp.asarray(toks, jnp.int32), cj, pj)
        lt, ct, _ = tmodel.extend_step(model, torch.from_numpy(toks), ct, pt)
        np.testing.assert_allclose(np.asarray(lj)[:2], lt[:2].numpy(),
                                   atol=ATOL)
        pj, pt = pj + L, pt + L
    if variant == "int8":
        # the quantized leaves themselves: int8 values and scales as the
        # reference wrote them (slot 0's live positions)
        n = int(pt[0])
        for i, c in enumerate(ct):
            jc = jax.tree.map(lambda a: np.asarray(a[i]), cj["body"]["p0"])
            if paged:
                jrow = {k: jattn.page_gather(jnp.asarray(jc[k]),
                                             jnp.asarray(jc["page_table"]))
                        for k in ("k", "k_scale")}
                trow = {k: tattn.page_gather(c[k], c["page_table"])
                        for k in ("k", "k_scale")}
            else:
                jrow, trow = jc, c
            np.testing.assert_allclose(np.asarray(jrow["k_scale"])[0, :n],
                                       trow["k_scale"][0, :n].numpy(),
                                       rtol=1e-5)
            d = np.abs(np.asarray(jrow["k"])[0, :n].astype(int)
                       - trow["k"][0, :n].numpy().astype(int))
            assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_transformer_defaults_to_the_card():
    cfg = configs.smoke_variant(configs.get_config("qwen2.5-3b"))
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default builds there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodel.Transformer(cfg)
    from repro_torch import prng
    from repro_torch.core import engine
    for fn in (prng.PRNGKey, engine.row_key, engine.cloud_row_key):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(0)
