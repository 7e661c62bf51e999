"""The reference's last API the port lacked, held against it on the CPU:
the packed wire's bit budget and codec v2's actuals
(``repro.core.bits``), Theorem 1's lattice term, ``ConformalConfig``,
the sort-based K-th largest oracle, ``cfg_speculate``,
``PagedSpec.tokens_per_slot_max``, ``ensure_slot_capacity`` and the
re-exports of ``repro.core``.

Integers must be equal; ``draft_message_reference_bits`` (a float64 sum
of float32 eq. (1) terms) within 1e-6 relative.  The reference's own
bit-for-bit checks run on the port: ``len(pack(p)) * 8`` is the wire
budget rounded up to whole bytes (v1 drafts, raw mode, verdicts), and
the v2 actuals stay in the bands ``tests/test_coding.py`` asserts.
"""
import ast
import dataclasses
import itertools
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import EdgeCloudEngine as RefEngine  # noqa: E402
from repro.core import EngineConfig as RefEngineConfig  # noqa: E402
from repro.core import MethodConfig as RefMethodConfig  # noqa: E402
from repro.core import bits as jbits  # noqa: E402
from repro.core import conformal as jconf  # noqa: E402
from repro.core import slq as jslq  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import events as jevents  # noqa: E402
from repro.serve import session as jsession  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core import bits as tbits  # noqa: E402
from repro_torch.core import coding as tcoding  # noqa: E402
from repro_torch.core import conformal as tconf  # noqa: E402
from repro_torch.core import slq as tslq  # noqa: E402
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,  # noqa: E402
                                     MethodConfig)
from repro_torch.core.wire import (DraftPayload, VerdictPayload,  # noqa: E402
                                   WireFormat)
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.serve import events as tevents  # noqa: E402
from repro_torch.serve import session as tsession  # noqa: E402

VS = (512, 50304, 151936)
ELLS = (1, 100, 1000)
L_MAXES = (1, 8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _Ks(V):
    return (1, 2, 64, V)


def _composition(rng, ell, K):
    """K counts >= 1 summing to ell (a lattice point on K support
    entries)."""
    cut = np.sort(rng.choice(ell - 1, K - 1, replace=False)) + 1 \
        if K > 1 else np.zeros(0, np.int64)
    return tuple(int(c) for c in np.diff(np.concatenate([[0], cut, [ell]])))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("V,ell,L_max", list(itertools.product(
    VS, ELLS, L_MAXES)))
def test_wire_budget_and_v2_actuals_equal_reference(V, ell, L_max):
    """Every function of the wire budget and the codec-v2 actuals, and
    Theorem 1's lattice term, on the grid: integers equal, the message
    reference within 1e-6 relative."""
    rng = np.random.default_rng(V + ell + L_max)
    assert tbits.wire_header_bits(L_max) == jbits.wire_header_bits(L_max)
    assert tbits.wire_raw_token_bits(V) == jbits.wire_raw_token_bits(V)
    assert tbits.wire_verdict_bits(V, L_max) == \
        jbits.wire_verdict_bits(V, L_max)
    for n in range(L_max + 1):
        assert tbits.wire_beta_bits(n) == jbits.wire_beta_bits(n)
    for x in (0, 1, L_max, ell, V - 1, V):
        assert tbits._width(x) == jbits._width(x)
    for T, tok in itertools.product(range(L_max + 1), (0, V // 3, V - 1)):
        got = tbits.coded_verdict_bits(T, tok, V, L_max)
        assert type(got) is int
        assert got == jbits.coded_verdict_bits(T, tok, V, L_max)
    for K in _Ks(V):
        got = tbits.wire_token_bits(V, K, ell)
        assert type(got) is int and got == jbits.wire_token_bits(V, K, ell)
        got = tbits.coded_subset_bits(V, K)
        assert type(got) is int and got == jbits.coded_subset_bits(V, K)
        if K <= ell:
            cnt = _composition(rng, ell, K)
            got = tbits.coded_counts_bits(cnt, ell)
            assert type(got) is int
            assert got == jbits.coded_counts_bits(cnt, ell)
        bound = tslq.slq_distortion_bound(K, ell)
        assert bound.dtype == torch.float32
        assert float(bound) == float(jslq.slq_distortion_bound(K, ell))
    for adaptive in (True, False):
        for Ks in ([1], list(_Ks(V))[:L_max],
                   [int(k) for k in rng.integers(1, V + 1, L_max)]):
            got = tbits.draft_message_reference_bits(V, ell, Ks, L_max,
                                                     adaptive)
            want = jbits.draft_message_reference_bits(V, ell, Ks, L_max,
                                                      adaptive)
            assert _rel(got, want) <= 1e-6, (Ks, adaptive, got, want)


def _lattice_payload(rng, fmt, n):
    toks, sups, cnts = [], [], []
    for _ in range(n):
        K = int(rng.integers(1, min(fmt.V, fmt.ell) + 1))
        sups.append(tuple(int(i) for i in np.sort(
            rng.choice(fmt.V, K, replace=False))))
        cnts.append(_composition(rng, fmt.ell, K))
        toks.append(int(rng.integers(0, fmt.V)))
    betas = tuple(float(np.float32(b)) for b in rng.normal(0, 0.3, n + 1))
    return DraftPayload(tokens=tuple(toks), supports=tuple(sups),
                        counts=tuple(cnts), betas=betas)


def _padded(bits_):
    return 8 * math.ceil(bits_ / 8)


@pytest.mark.parametrize("kind", ["v1 draft", "raw", "verdict"])
def test_packed_bits_are_the_wire_budget(kind):
    """The reference's tests/test_wire.py checks on the port: the packed
    message is the ``core.bits`` wire budget rounded up to whole bytes,
    over random payloads of every draft count."""
    rng = np.random.default_rng(7)
    for V, ell, L_max in ((257, 100, 6), (50304, 100, 8), (33, 10, 1)):
        mode = "raw" if kind == "raw" else "lattice"
        fmt = WireFormat(V=V, ell=ell, L_max=L_max, mode=mode)
        for n in range(L_max + 1):
            if kind == "verdict":
                v = VerdictPayload(n_accept=n,
                                   new_token=int(rng.integers(0, V)),
                                   beta_next=float(np.float32(
                                       rng.normal())))
                assert len(fmt.pack_verdict(v)) * 8 == _padded(
                    tbits.wire_verdict_bits(V, L_max))
                continue
            if kind == "raw":
                q = rng.dirichlet(np.ones(V), size=n).astype(np.float32)
                p = DraftPayload(
                    tokens=tuple(int(t) for t in rng.integers(0, V, n)),
                    supports=((),) * n, counts=((),) * n,
                    betas=(0.0,) * (n + 1),
                    probs=tuple(tuple(float(x) for x in row) for row in q))
                body = n * tbits.wire_raw_token_bits(V)
            else:
                p = _lattice_payload(rng, fmt, n)
                body = sum(tbits.wire_token_bits(V, len(s), ell)
                           for s in p.supports)
            want = tbits.wire_header_bits(L_max) + body + \
                tbits.wire_beta_bits(n)
            assert len(fmt.pack_draft(p)) * 8 == _padded(want)


@pytest.mark.parametrize("check", ["subset", "counts", "message",
                                   "verdict"])
def test_v2_actuals_within_the_reference_bands(check):
    """tests/test_coding.py's and tests/test_wire.py's bands, on the
    port: the coded support within one bit of log2 C(V, K), the Rice
    counts at most 2x eq. (2) + 16 and equal to the codec's own count,
    a coded message within 1.15x the message reference + 64, a coded
    verdict at most one bit over the fixed-width one."""
    rng = np.random.default_rng(3)
    if check == "subset":
        for V, K in itertools.product((512, 50257, 151936),
                                      (1, 4, 16, 64, 256)):
            ent = float(tbits.subset_bits_topk(V, float(K)))
            assert ent - 1e-3 <= tbits.coded_subset_bits(V, K) <= ent + 1.0
    elif check == "counts":
        ell = 100
        for K in (2, 8, 32, 64):
            cnt = _composition(rng, ell, K)
            got = tbits.coded_counts_bits(cnt, ell)
            assert got == tcoding.rice_counts_bits(cnt, ell)
            assert got <= 2.0 * tbits.payload_bits(float(K), ell) + 16
    elif check == "message":
        V, ell, L = 512, 100, 6
        fmt = WireFormat(V=V, ell=ell, L_max=L, codec="v2")
        for _ in range(10):
            p = _lattice_payload(rng, fmt, int(rng.integers(1, L + 1)))
            ref = tbits.draft_message_reference_bits(
                V, ell, [len(s) for s in p.supports], L, adaptive=True)
            assert tcoding.coded_draft_bits(fmt, p) <= 1.15 * ref + 64
    else:
        for V, L_max in ((257, 8), (50257, 4)):
            for T in range(L_max + 1):
                assert tbits.coded_verdict_bits(T, V - 1, V, L_max) <= \
                    tbits.wire_verdict_bits(V, L_max) + 1


def _smoke_engines():
    jc = jconfigs.smoke_variant(jconfigs.get_config("qwen2.5-3b"))
    jd = jconfigs.draft_variant(jc, 2)
    tc = configs.smoke_variant(configs.get_config("qwen2.5-3b"))
    td = configs.draft_variant(tc, 2)
    jp = [jmodel.init_params(c, jax.random.PRNGKey(s))
          for c, s in ((jd, 2), (jc, 1))]
    tp = [bridge.from_jax(jax.tree.map(np.asarray, p), c, device="cpu")
          for p, c in zip(jp, (td, tc))]
    ref = RefEngine(jd, jp[0], jc, jp[1], RefMethodConfig(name="ksqs"),
                    RefEngineConfig(L_max=3), seed=0)
    port = EdgeCloudEngine(td, tp[0], tc, tp[1], MethodConfig(name="ksqs"),
                           EngineConfig(L_max=3), seed=0, device="cpu")
    return ref, port


@pytest.mark.parametrize("name", ["ConformalConfig", "kth_largest_ref",
                                  "cfg_speculate", "tokens_per_slot_max",
                                  "ensure_slot_capacity"])
def test_small_api_equals_reference(name):
    if name == "ConformalConfig":
        assert tconf.ConformalConfig() == jconf.ConformalConfig()
        assert tconf.ConformalConfig._fields == jconf.ConformalConfig._fields
        assert tconf.ConformalConfig(alpha=0.1) == \
            jconf.ConformalConfig(alpha=0.1)
    elif name == "kth_largest_ref":
        rng = np.random.default_rng(0)
        for V in VS:
            q = rng.random((3, V)).astype(np.float32)
            q[1, :8] = q[1, 8]                 # ties at the top
            for K in _Ks(V):
                got = tref.kth_largest_ref(torch.from_numpy(q), K)
                want = np.asarray(jref.kth_largest_ref(jnp.asarray(q), K))
                np.testing.assert_array_equal(got.numpy(), want)
    elif name == "cfg_speculate":
        for spec in (True, False):
            assert tevents.cfg_speculate(tsession.ServeConfig(
                speculate=spec)) == jevents.cfg_speculate(
                    jsession.ServeConfig(speculate=spec)) == spec
        assert tevents.cfg_speculate(object()) == \
            jevents.cfg_speculate(object()) is True
    elif name == "tokens_per_slot_max":
        for ps, n, maxp in ((8, 12, 4), (16, 8193, 256), (1, 1, 1)):
            t = tattn.PagedSpec(page_size=ps, n_pages=n,
                                max_pages_per_slot=maxp)
            j = jattn.PagedSpec(page_size=ps, n_pages=n,
                                max_pages_per_slot=maxp)
            assert t.tokens_per_slot_max == j.tokens_per_slot_max
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
    else:
        ref, port = _smoke_engines()
        for eng in (ref, port):
            eng.init_slots(3, 48)              # dense: always room
            assert eng.ensure_slot_capacity(0, 48) is True
            eng.init_slots(3, 48, page_size=8, n_pages=10)
        for slot, n in ((0, 9), (1, 17), (0, 30), (2, 48), (1, 40),
                        (2, 8)):
            assert port.ensure_slot_capacity(slot, n) == \
                ref.ensure_slot_capacity(slot, n)
            np.testing.assert_array_equal(port.alloc.table, ref.alloc.table)
            assert port.alloc.free_pages == ref.alloc.free_pages


def _reference_core_names():
    """The names ``src/repro/core/__init__.py`` binds."""
    path = os.path.join(REPO, "src", "repro", "core", "__init__.py")
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return names


def test_core_reexports_equal_reference():
    """``repro_torch.core`` exports every name ``repro.core`` does, each
    the port module's own object; importing the package (or one of its
    modules) loads no other module of the port."""
    import repro_torch.core as tcore
    names = _reference_core_names()
    assert names <= set(tcore.__all__), names - set(tcore.__all__)
    for name in names:
        value = getattr(tcore, name)
        if isinstance(value, types.ModuleType):
            assert value.__name__ == f"repro_torch.core.{name}"
            continue
        home = sys.modules[value.__module__]
        assert home.__name__.startswith("repro_torch.core."), name
        assert getattr(home, "verify" if name == "sd_verify" else name) \
            is value
    code = ("import sys, repro_torch.core, repro_torch.core.bits; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch')))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(REPO, "src")))
    assert out.stdout.split() == [
        "['repro_torch',", "'repro_torch.core',", "'repro_torch.core.bits']"]
