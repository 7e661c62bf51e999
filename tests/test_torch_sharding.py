"""The port's sharding tooling against the reference's
(``repro_torch.sharding.partition`` / ``launch.comm_analysis`` /
``launch.dryrun`` vs ``repro.sharding.partition`` / ``launch.hlo_analysis``
/ the dry run's skip rules).

- Parameter specs equal the reference's PartitionSpecs leaf by leaf for
  every ``ASSIGNED`` arch, on both production meshes, with FSDP off and
  on, the stacking axis of the reference's body and encoder leaves
  dropped.  Where the reference's FSDP shards that stacking axis
  (qwen2-vl-72b's 80 layers on the 16 x 16 mesh, the leaves named in
  ``STACKED_FSDP``), the port's per-layer leaves hold the same elements
  a device.
- Cache specs (decode_32k; long_500k with the sequence sharded; the
  sequence fallback on and off) and batch specs ((3, B, S) positions
  included) equal the reference's.
- ``comm_analysis`` reproduces the reference's HLO sample arithmetic on a
  hand-built DTensor program over a fake mesh.
- The dry run's skip decisions equal the reference's for all 80 arch x
  shape x mesh combinations, and ``run_combo`` reaches ``ok`` on smoke
  variants of a dense (decode and train), a MoE, an SSM, a hybrid and an
  MLA config on a (2, 4) fake mesh; on a (1, 1) fake mesh its FLOPs
  equal ``FlopCounterMode`` of the same step run unsharded on CPU
  tensors.
- On those smoke combos: a vocab-sharded train step makes no storage
  whose last dim is the vocabulary, and no all-gather gathers a large
  SSM mixer projection or a state over ``model``.
- The calibrated count (``calibrate=True``) of smoke combos that also
  trace whole equals the whole trace's FLOPs, bytes accessed and
  collectives exactly, its extrapolated peak within 2 %.

The reference's ``repro.launch.dryrun`` is never imported here: it sets
XLA_FLAGS at import.  Specs are built from sizes only (a ``FakeMesh``),
as ``tests/test_sharding.py`` does; the port's models are built on the
meta device.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.sharding import partition as jpart  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, ShapeSpec, for_shape  # noqa: E402
from repro_torch.launch import comm_analysis, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_fake_mesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.sharding import partition as tpart  # noqa: E402

MESHES = [({"data": 16, "model": 16}, None),
          ({"pod": 2, "data": 16, "model": 16}, "pod")]

# the reference's FSDP shards the stacking axis of these body leaves:
# qwen2-vl-72b (80 layers) on the 16 x 16 mesh, and nowhere else
STACKED_FSDP = {("qwen2-vl-72b", 2): {
    "attn/b_k", "attn/b_q", "attn/b_v", "attn/w_k", "attn/w_o", "attn/w_q",
    "attn/w_v", "mlp/w_down", "mlp/w_gate", "mlp/w_up", "norm1", "norm2"}}


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _norm(spec):
    """A spec as a tuple, a one-name tuple entry as the name
    (``PartitionSpec`` stores ("data",) as "data")."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _ref_tree(tree, path):
    node = tree
    for key in path:
        if isinstance(key, int):
            break
        node = node[key]
    return node


def _elems(shape, spec, sizes):
    n = 1
    for d, ax in zip(shape, spec):
        k = 1
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            k *= sizes[a]
        assert d % k == 0, (shape, spec)
        n *= d // k
    return n


@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_param_specs_equal_reference(arch):
    jcfg = jconfigs.get_config(arch)
    sds = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k),
                         jax.random.PRNGKey(0))
    model = tmodel.Transformer(configs.get_config(arch), device="meta")
    for sizes, pod in MESHES:
        for fsdp in (False, True):
            ref = jpart.Partitioner(jcfg, FakeMesh(sizes),
                                    jpart.MeshAxes(pod=pod),
                                    fsdp=fsdp).param_specs(sds)
            got = tpart.Partitioner(configs.get_config(arch),
                                    FakeMesh(sizes), tpart.MeshAxes(pod=pod),
                                    fsdp=fsdp).param_specs(model)
            stacked_hits = set()
            # every stacked leaf family: per-device elements summed over
            # its layers
            fam = {}
            for prm, path, spec in got:
                rspec, spec = _norm(_ref_tree(ref, path)), _norm(spec)
                rleaf = _ref_tree(sds, path)
                if not isinstance(path[-1], int):
                    assert spec == rspec, (arch, path, spec, rspec)
                    assert tuple(prm.shape) == tuple(rleaf.shape)
                    continue
                assert tuple(prm.shape) == tuple(rleaf.shape[1:])
                if rspec[0] is None:
                    assert spec == rspec[1:], (arch, path, spec, rspec)
                    continue
                name = "/".join(k for k in path[2:-1]
                                if isinstance(k, str)) if \
                    path[0] == "body" else "/".join(path[1:-1])
                stacked_hits.add(name)
                key = path[:-1]
                fam.setdefault(key, [0, rleaf.shape, rspec])
                fam[key][0] += _elems(prm.shape, spec, sizes)
            for key, (n, rshape, rspec) in fam.items():
                assert n == _elems(rshape, rspec, sizes), (arch, key)
            want = STACKED_FSDP.get((arch, len(sizes)), set()) if fsdp \
                else set()
            assert stacked_hits == want, (arch, sizes, fsdp, stacked_hits)


def test_moe_indivisible_experts_fall_back():
    """qwen2-moe's 60 experts do not divide 16: the expert weights shard
    the per-expert FFN dim, as the reference's."""
    cfg = configs.get_config("qwen2-moe-a2.7b")
    model = tmodel.Transformer(cfg, device="meta")
    part = tpart.Partitioner(cfg, FakeMesh({"data": 16, "model": 16}),
                             tpart.MeshAxes())
    specs = {path: s for _, path, s in part.param_specs(model)}
    assert specs[("body", "p0", "moe", "w_gate", 0)] == (None, None, "model")
    assert specs[("body", "p0", "moe", "w_down", 0)] == (None, "model", None)


def _ref_cache_leaf(ref, cfg, i, name):
    """The reference's spec of port layer i's cache leaf, its stacking
    axis dropped."""
    P, n = cfg.period, cfg.n_prefix_layers
    if i < n:
        return _norm(ref["prefix"][f"l{i}"][name])
    j = i - n
    if name in ("cross_k", "cross_v"):
        return _norm(ref["cross"][f"p{j % P}"][name[-1]])[1:]
    return _norm(ref["body"][f"p{j % P}"][name])[1:]


@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_cache_and_batch_specs_equal_reference(arch):
    for shape_name in ("decode_32k", "long_500k"):
        shape = INPUT_SHAPES[shape_name]
        jshape = jbase.INPUT_SHAPES[shape_name]
        cfg = for_shape(configs.get_config(arch), shape)
        jcfg = jbase.for_shape(jconfigs.get_config(arch), jshape)
        if cfg.is_mla and cfg.attention == "sliding":
            continue            # the port refuses MLA with a window
        enc = dryrun.ENC_LEN if cfg.n_encoder_layers else 0
        B, S = shape.batch, shape.seq
        jcache = jax.eval_shape(
            lambda: jmodel.init_cache(jcfg, B, S, enc_seq=enc))
        model = tmodel.Transformer(cfg, device="meta")
        cache = tmodel.init_cache(model, B, S, enc_seq=enc)
        for sizes, pod in MESHES:
            for fallback in (False, True):
                ref = jpart.Partitioner(
                    jcfg, FakeMesh(sizes), jpart.MeshAxes(pod=pod),
                    seq_shard_fallback=fallback).cache_specs(
                        jcache, shard_seq=shape.long_context)
                got = tpart.Partitioner(
                    cfg, FakeMesh(sizes), tpart.MeshAxes(pod=pod),
                    seq_shard_fallback=fallback).cache_specs(
                        cache, shard_seq=shape.long_context)
                assert len(got) == cfg.n_layers
                for i, layer in enumerate(got):
                    for name, spec in layer.items():
                        assert _norm(spec) == _ref_cache_leaf(ref, cfg, i,
                                                              name), \
                            (arch, shape_name, i, name)
    # batches: tokens, frontend frames, (3, B, S) M-RoPE positions
    cfg = configs.get_config(arch)
    for B in (256, 1, 24):
        batch = {"tokens": torch.empty((B, 4097), device="meta"),
                 "enc_embeds": torch.empty((B, 64, 8), device="meta"),
                 "positions": torch.empty((3, B, 4096), device="meta")}
        jb = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
              for k, v in batch.items()}
        for sizes, pod in MESHES:
            ref = jpart.Partitioner(jconfigs.get_config(arch), FakeMesh(sizes),
                                    jpart.MeshAxes(pod=pod)).batch_specs(jb)
            got = tpart.Partitioner(cfg, FakeMesh(sizes),
                                    tpart.MeshAxes(pod=pod)).batch_specs(batch)
            assert {k: _norm(v) for k, v in got.items()} == \
                {k: _norm(v) for k, v in ref.items()}


HLO_SAMPLE_BODY_TRIPS = 10


def test_comm_analysis_reproduces_reference_sample():
    """The reference sample (``tests/test_sharding.py``): one all-gather
    with a 512 x 512 f32 result, then ten loop trips of an all-gather and
    an all-reduce of 128 x 256 f32, as a DTensor program over a 16-rank
    fake mesh; the port's sums equal the reference parser's."""
    from test_sharding import HLO_SAMPLE
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    st = hlo_analysis.analyze_collectives(HLO_SAMPLE,
                                          scan_trip_count=HLO_SAMPLE_BODY_TRIPS)
    mesh = make_fake_mesh((16,), ("model",), device="cpu")
    with FakeTensorMode():
        a = DTensor.from_local(torch.empty(512, 32), mesh, [Shard(1)],
                               run_check=False)
        with comm_analysis.DeviceCostMode() as mode:
            a.redistribute(mesh, [Replicate()])
            for _ in range(HLO_SAMPLE_BODY_TRIPS):
                x = DTensor.from_local(torch.empty(128, 16), mesh,
                                       [Shard(1)], run_check=False)
                g = x.redistribute(mesh, [Replicate()])
                p = DTensor.from_local(g.to_local(), mesh, [Partial()],
                                       run_check=False)
                p.redistribute(mesh, [Replicate()])
    got = comm_analysis.collective_summary(mode)
    assert got["per_kind_bytes"] == st.per_kind_bytes
    assert got["total_collective_bytes"] == st.total_bytes
    assert got["per_kind_count"] == {"all-gather": 11, "all-reduce": 10}


def _ref_decision(arch, shape_name):
    """The reference dry run's skip rules (``repro.launch.dryrun.
    run_combo``), from its configs: the reason, or None to run; and its
    FSDP choice."""
    jshape = jbase.INPUT_SHAPES[shape_name]
    base = jconfigs.get_config(arch)
    cfg = jbase.for_shape(base, jshape)
    ok, why = jbase.supports_shape(cfg, jshape)
    if not ok:
        return why, None
    if not (not jshape.long_context or cfg.sub_quadratic):
        return "full attention at 500k (DESIGN.md long_500k policy)", None
    return None, jshape.kind == "train" and base.param_count() > 50e9


def test_dryrun_skip_decisions_equal_reference():
    n = 0
    for arch in configs.ASSIGNED:
        for shape_name, shape in INPUT_SHAPES.items():
            for multi_pod in (False, True):
                want, want_fsdp = _ref_decision(arch, shape_name)
                base = configs.get_config(arch)
                got = dryrun.skip_reason(for_shape(base, shape), shape)
                assert got == want, (arch, shape_name)
                if want is None:
                    assert dryrun.default_fsdp(base, shape) == want_fsdp
                else:
                    rec = dryrun.run_combo(arch, shape_name, multi_pod,
                                           device="cpu")
                    assert rec["status"] == "skipped"
                    assert rec["reason"] == want
                    assert rec["mesh"] == ("pod2x16x16" if multi_pod
                                           else "pod16x16")
                n += 1
    assert n == 80


SMOKE_COMBOS = [
    ("qwen2.5-3b", "decode_32k", dryrun.Options()),
    ("qwen2-moe-a2.7b", "decode_32k",
     dryrun.Options(shard_acts=True, moe_groups=True)),
    ("xlstm-1.3b", "long_500k", dryrun.Options()),
    ("deepseek-v2-lite-16b", "decode_32k", dryrun.Options()),
    ("qwen2.5-3b", "train_4k", dryrun.Options()),
    ("jamba-1.5-large-398b", "decode_32k", dryrun.Options()),
]


def _new_storage_shapes(monkeypatch):
    """Patches ``DeviceCostMode`` to record the shape of every tensor a
    rank's local ops make on a new storage; returns the list."""
    shapes = []
    track = comm_analysis.DeviceCostMode._track

    def _track(mode, out, inputs=()):
        from torch.utils._pytree import tree_flatten
        seen = set(map(id, mode._seen))
        shapes.extend(tuple(t.shape) for t in tree_flatten(out)[0]
                      if isinstance(t, torch.Tensor)
                      and id(t.untyped_storage()) not in seen)
        return track(mode, out, inputs)

    monkeypatch.setattr(comm_analysis.DeviceCostMode, "_track", _track)
    return shapes


@pytest.mark.parametrize("arch,shape_name,opts", SMOKE_COMBOS)
def test_run_combo_smoke_ok(arch, shape_name, opts):
    cfg = configs.smoke_variant(configs.get_config(arch))
    rec = dryrun.run_combo(arch, shape_name, device="cpu", cfg=cfg,
                           mesh_shape=(2, 4), opts=opts)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_chips"] == 8
    assert rec["memory"]["peak_per_device"] > rec["memory"]["argument_bytes"]
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["collectives"]["total_collective_bytes"] > 0
    if opts.moe_groups:
        assert rec["levers"]["moe_groups"] == 2


@pytest.mark.parametrize("arch,shape_name,opts", [
    c for c in SMOKE_COMBOS if c[0] in ("xlstm-1.3b",
                                        "jamba-1.5-large-398b")])
def test_smoke_ssm_gathers_no_mixer_projection_or_state(arch, shape_name,
                                                       opts):
    """No all-gather over ``model`` has the result shape of a large SSM
    mixer projection or of a recurrent state (``dryrun.whole_over_model``,
    against the shapes ``DeviceCostMode`` records): each mixer runs on
    its shard."""
    cfg = configs.smoke_variant(configs.get_config(arch))
    rec = dryrun.run_combo(arch, shape_name, device="cpu", cfg=cfg,
                           mesh_shape=(2, 4), opts=opts)
    assert rec["status"] == "ok", rec.get("traceback")
    shape = INPUT_SHAPES[shape_name]
    mesh = make_fake_mesh((2, 4), ("data", "model"), device="cpu")
    forbidden = dryrun.whole_over_model(for_shape(cfg, shape), shape, mesh,
                                        tpart.MeshAxes())
    assert len(forbidden) >= 4
    assert rec["collectives"]["per_kind_count"]["all-gather"] > 0
    assert rec["collectives"]["whole_mixer_gathers"] == 0


def test_vocab_sharded_train_step_makes_no_full_vocab_storage(monkeypatch):
    """The vocab-parallel cross entropy (``sharding.local.nll_last``):
    no tensor a rank makes in a train step has the whole vocabulary as
    its last dim (the logits, their log-softmax and their gradient stay
    (B, S, V / 4) blocks)."""
    new = _new_storage_shapes(monkeypatch)
    V = 1000                         # divides 4; no other dim of the step
    cfg = dataclasses.replace(configs.smoke_variant(
        configs.get_config("qwen2.5-3b")), vocab=V)
    rec = dryrun.run_combo("qwen2.5-3b", "train_4k", device="cpu", cfg=cfg,
                           mesh_shape=(2, 4))
    assert rec["status"] == "ok", rec.get("traceback")
    assert (128, 4096, V // 4) in new
    assert not [s for s in new if s and s[-1] == V]


# (arch, step kind, units, positions): sLSTM's training recurrence over
# 96 positions keeps enough alive for its backward to weigh in the peak
CAL_COMBOS = [("qwen2.5-3b", "decode", 3, 24), ("qwen2.5-3b", "train", 3, 24),
              ("xlstm-1.3b", "prefill", 3, 24), ("xlstm-1.3b", "train", 3, 96)]


@pytest.mark.parametrize("arch,kind,units,seq", CAL_COMBOS)
def test_calibrated_count_equals_whole_trace(arch, kind, units, seq):
    """The calibrated count (``CAL_UNITS`` units traced, the position
    loops' trips multiplied, the train update traced whole) against the
    whole trace of a smoke config of ``units`` units: FLOPs, bytes
    accessed and every collective kind's count and bytes equal, the
    extrapolated peak within 2 %."""
    base = configs.smoke_variant(configs.get_config(arch))
    cfg = dataclasses.replace(base, n_layers=base.n_prefix_layers
                              + units * base.period)
    spec = ShapeSpec("smoke_" + kind, kind, seq, 4)
    assert dryrun.n_units(cfg) == units > max(dryrun.CAL_UNITS)
    whole, cal = (dryrun.run_combo(arch, spec.name, device="cpu", cfg=cfg,
                                   mesh_shape=(2, 4), spec=spec,
                                   calibrate=c) for c in (False, True))
    assert whole["status"] == cal["status"] == "ok", cal.get("traceback")
    assert "scan_calibration" not in whole
    assert cal["calibration_status"] == "ok"
    sc = cal["scan_calibration"]
    assert sc["n_units"] == units
    assert set(sc) >= {f"cost_{n}p" for n in dryrun.CAL_UNITS}
    assert cal["memory"]["peak_extrapolated"]
    assert not whole["memory"]["peak_extrapolated"]
    assert cal["cost"] == whole["cost"]
    for key in ("per_kind_bytes", "per_kind_count"):
        assert cal["collectives"][key] == whole["collectives"][key]
    assert cal["memory"]["argument_bytes"] == \
        whole["memory"]["argument_bytes"]
    ratio = cal["memory"]["peak_per_device"] / \
        whole["memory"]["peak_per_device"]
    assert abs(ratio - 1) <= 0.02, ratio


TINY = {"decode": ShapeSpec("tiny_decode", "decode", 48, 4),
        "train": ShapeSpec("tiny_train", "train", 32, 4)}


@pytest.mark.parametrize("kind", ["decode", "train"])
def test_one_rank_flops_equal_unsharded_flop_counter(kind):
    """On a (1, 1) fake mesh the dry run's per-device FLOPs are the whole
    step's: ``FlopCounterMode`` over the same step on plain CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import bridge
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.trainer import make_train_step, parameters
    arch = "qwen2.5-3b"
    cfg = dataclasses.replace(configs.smoke_variant(configs.get_config(arch)),
                              n_layers=2)
    spec = TINY[kind]
    rec = dryrun.run_combo(arch, spec.name, device="cpu", cfg=cfg,
                           mesh_shape=(1, 1), spec=spec)
    assert rec["status"] == "ok", rec.get("traceback")
    B, S = spec.batch, spec.seq
    model = bridge.seeded_model(cfg, 0, "cpu", trainable=kind == "train")
    if kind == "decode":
        cache = tmodel.init_cache(model, B, S)
        tok = torch.zeros(B, dtype=torch.int64)
        pos = torch.full((B,), S - 1, dtype=torch.int64)
        with FlopCounterMode(display=False) as fc:
            tmodel.decode_step(model, tok, cache, pos)
    else:
        params = parameters(model)
        st = opt_mod.init_state(params)
        step = make_train_step(cfg, opt_mod.AdamWConfig())
        batch = {"tokens": torch.zeros((B, S + 1), dtype=torch.int64)}
        with FlopCounterMode(display=False) as fc:
            step(model, st, batch)
    assert rec["cost"]["flops"] == fc.get_total_flops() > 0


def test_tooling_imports_touch_nothing():
    """Importing the tooling initialises no process group and sets no
    environment variable (the reference's dry run sets XLA_FLAGS at
    import)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import os, json; before = dict(os.environ)\n"
        "import torch.distributed as dist\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
        "import repro_torch.launch.comm_analysis\n"
        "import repro_torch.sharding.partition, repro_torch.sharding.local\n"
        "import repro_torch.sharding.act_sharding as a\n"
        "from repro_torch.launch import mesh\n"
        "assert not dist.is_initialized()\n"
        "assert dict(os.environ) == before\n"
        "assert a.MESH is None and a.AXES is None\n"
        "assert not any(n.startswith(('jax', 'repro.')) for n in "
        "__import__('sys').modules)\n"
        "assert mesh.PEAK_FLOPS_BF16 == 989e12\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.stdout.strip() == "OK", r.stdout + r.stderr
