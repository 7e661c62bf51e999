"""Production-mesh dry run (mirrors ``repro.launch.dryrun``).

For every (architecture x input shape x mesh) combination this builds
the port's model on the meta device, distributes it by the
``Partitioner`` as DTensors on the production mesh (a fake process group
of 256 or 512 ranks, ``launch.mesh``) and runs ONE step of rank 0 under
``FakeTensorMode``: no memory is allocated, no collective moves data,
and the step is the real program of one device of that mesh.  It
records the device's memory, FLOPs, bytes accessed and collectives:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Shapes -> steps:
    train_4k    -> ``train.trainer.make_train_step`` (loss, gradients,
                   AdamW on float32 masters and moments)
    prefill_32k -> ``models.model.prefill`` (prompt -> cache)
    decode_32k  -> ``models.model.decode_step`` (ONE token against a
                   seq_len cache)
    long_500k   -> decode, sub-quadratic variants only, the cache's
                   sequence sharded over the data axes

The reference's environment switches are flags: ``--seq-shard-kv``,
``--shard-acts``, ``--seq-parallel``, ``--moe-groups``, ``--kv-int8``,
with its rules (sequence-parallel residuals are dropped for configs
with SSM blocks, MoE dispatch groups under FSDP training).  ``--device``
(cuda by default) picks the branch the model code traces: on cuda the
KV cache is read in place by ``attention._cache_bmm``, on the CPU
widened to float32.

Record keys are the reference's: ``status`` (ok | skipped | error) with
``reason`` or ``error``; ``memory`` (``argument_bytes``: the local
shards of parameters, optimizer state, cache and inputs;
``output_bytes``: the step's new outputs; ``temp_bytes``; and
``peak_per_device`` = arguments + the step's peak of live local
storage, ``comm_analysis.DeviceCostMode.peak``, counted as
``MemTracker`` counts but without its gradient hooks on every module's
parameters, which the serve path's gradient-free parameters refuse);
``cost`` (``flops``, ``bytes accessed``: ``comm_analysis``'s counts of
the local ops); ``collectives``; ``n_chips``; and ``trace_s`` in place
of ``lower_s`` / ``compile_s``.  The reference's ``--calibrate`` has no
counterpart: it corrects XLA's cost analysis, which counts a layer
scan's body once, and the port's layers are a Python loop whose every
trip is counted.

``run_rank0`` runs the same step for real on the card as rank 0 of the
same fake group: real local shards from a seeded generator, no-op
collectives (so values are not checked), ``torch.cuda.max_memory_allocated``
beside the dry run's peak, the same FLOP count, and the local step's
time by CUDA events (compute without communication).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, for_shape, supports_shape
from repro_torch.launch import comm_analysis
from repro_torch.launch.mesh import (make_fake_mesh, make_production_mesh,
                                     mesh_axes)
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.sharding import act_sharding
from repro_torch.sharding.partition import (MeshAxes, Partitioner,
                                            distribute, dtensor_like,
                                            local_shape, mesh_sizes,
                                            shard_bytes)
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import make_train_step, parameters

ENC_LEN = 4096          # audio-frontend stub frames (enc-dec combos)


@dataclasses.dataclass(frozen=True)
class Options:
    """The reference's REPRO_* switches."""
    seq_shard_kv: bool = False      # REPRO_SEQ_SHARD_KV
    shard_acts: bool = False        # REPRO_SHARD_ACTS
    seq_parallel: bool = False      # REPRO_SEQ_PARALLEL
    moe_groups: bool = False        # REPRO_MOE_GROUPS
    kv_int8: bool = False           # REPRO_KV_INT8


def mesh_name(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape is not None:
        return "fake" + "x".join(map(str, mesh_shape))
    return "pod2x16x16" if multi_pod else "pod16x16"


def _mesh(multi_pod, mesh_shape, device):
    if mesh_shape is None:
        return (make_production_mesh(multi_pod=multi_pod, device=device),
                mesh_axes(multi_pod=multi_pod))
    shape = tuple(mesh_shape)
    names = ("data", "model") if len(shape) == 2 else \
        ("pod", "data", "model")
    return (make_fake_mesh(shape, names, device=device),
            MeshAxes(pod="pod" if len(shape) == 3 else None))


def _set_levers(cfg, shape, mesh, axes, fsdp: bool, opts: Options):
    """The reference's build_lowered switches; returns what was applied."""
    if opts.shard_acts:
        # sequence-parallel residuals are attention/FFN-only: SSM blocks
        # mix along the sequence, so they keep the reference's fallback
        has_ssm = any(b in ("mamba", "mlstm", "slstm")
                      for b in cfg.block_pattern)
        seq_par = opts.seq_parallel and not has_ssm
        act_sharding.set_mesh(mesh, axes, seq_parallel=seq_par)
    else:
        seq_par = False
        act_sharding.set_mesh(None, None)
    # the grouped dispatch assumes model-axis-only weight sharding; under
    # FSDP training it would re-gather the weights, as in the reference
    groups = opts.moe_groups and not (shape.kind == "train" and fsdp)
    moe_mod.GROUPS = mesh_sizes(mesh)[axes.data] if groups else 1
    return {"shard_acts": opts.shard_acts, "seq_parallel": seq_par,
            "moe_groups": moe_mod.GROUPS}


def _reset_levers():
    act_sharding.set_mesh(None, None)
    moe_mod.GROUPS = 1


class _Filler:
    """Real local shards for ``run_rank0``: the reference's init
    distributions (``bridge``) drawn from one generator on the card,
    caches zero, tokens uniform over the vocabulary."""

    def __init__(self, gen, vocab: int):
        self.gen, self.vocab = gen, vocab

    def param(self, local, path):
        from repro_torch.bridge import _fan_in, _fill_constant
        if not _fill_constant(local, path):
            std = 1.0 / math.sqrt(_fan_in(path, local.shape))
            local.copy_(torch.randn(local.shape, generator=self.gen,
                                    device=local.device) * std)

    def tokens(self, local):
        local.copy_(torch.randint(0, self.vocab, local.shape,
                                  generator=self.gen, device=local.device))


def _local_input(t, spec, mesh, device, filler=None, kind="zeros"):
    """A DTensor input of ``t``'s (meta) shape and dtype under ``spec``."""
    shp = local_shape(t.shape, spec, mesh_sizes(mesh))
    local = torch.zeros(shp, dtype=t.dtype, device=device)
    if filler is not None and kind == "tokens":
        filler.tokens(local)
    elif filler is not None and kind == "normal":
        local.copy_(torch.randn(shp, generator=filler.gen, device=device)
                    * 0.02)
    return dtensor_like(t, spec, mesh, local=local)


def build_step(cfg, shape, mesh, axes, fsdp: bool, opts: Options, device,
               filler=None):
    """(step thunk, argument bytes) for one rank of ``mesh``; under
    ``FakeTensorMode`` when ``filler`` is None (the caller enters it)."""
    part = Partitioner(cfg, mesh, axes, fsdp=fsdp,
                       seq_shard_fallback=opts.seq_shard_kv)
    sizes = mesh_sizes(mesh)
    B, S = shape.batch, shape.seq
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")  # noqa
    fill = None if filler is None else filler.param
    train = shape.kind == "train"
    model = model_mod.Transformer(cfg, device="meta", trainable=train)
    cache_meta = None
    if shape.kind == "decode":
        cache_meta = model_mod.init_cache(
            model, B, S, enc_seq=ENC_LEN if cfg.n_encoder_layers else 0)
    specs = part.param_specs(model)
    arg_bytes = sum(shard_bytes(prm, s, sizes) for prm, _, s in specs)
    distribute(model, part, device=device, fill=fill)

    def inputs(batch):
        bspec = part.batch_specs(batch)
        out = {}
        for name, t in batch.items():
            kind = "tokens" if t.dtype == torch.int64 else "normal"
            out[name] = _local_input(t, bspec[name], mesh, device, filler,
                                     kind)
        return out, sum(shard_bytes(t, bspec[n], sizes)
                        for n, t in batch.items())

    if train:
        params = parameters(model)
        opt_state = opt_mod.init_state(params)
        ospec = part.opt_state_specs(model)
        arg_bytes += sum(shard_bytes(prm, s, sizes) for key in ("m", "v")
                         for prm, s in zip(params, ospec[key]))
        batch = {"tokens": meta((B, S + 1), torch.int64)}
        if cfg.n_encoder_layers:
            batch["enc_embeds"] = meta((B, ENC_LEN, cfg.d_model),
                                       model.dtype)
        batch, nb = inputs(batch)
        arg_bytes += nb
        step = make_train_step(cfg, opt_mod.AdamWConfig(), microbatches=1)
        return (lambda: step(model, opt_state, batch)[2]), arg_bytes

    if shape.kind == "prefill":
        args = {"tokens": meta((B, S), torch.int64)}
        if cfg.n_encoder_layers:
            args["enc_embeds"] = meta((B, ENC_LEN, cfg.d_model),
                                      model.dtype)
        args, nb = inputs(args)
        arg_bytes += nb
        return (lambda: model_mod.prefill(
            model, args["tokens"], cache_len=S,
            enc_embeds=args.get("enc_embeds"))), arg_bytes

    # decode: ONE new token against a cache of seq_len
    cspec = part.cache_specs(cache_meta, shard_seq=shape.long_context)
    cache = [{n: _local_input(t, cspec[i][n], mesh, device)
              for n, t in c.items()} for i, c in enumerate(cache_meta)]
    arg_bytes += sum(shard_bytes(t, cspec[i][n], sizes)
                     for i, c in enumerate(cache_meta)
                     for n, t in c.items())
    tspec = (part._dp(B),)
    token = _local_input(meta((B,), torch.int64), tspec, mesh, device,
                         filler, "tokens")
    pos = _local_input(meta((B,), torch.int64), tspec, mesh, device)
    if filler is not None:
        pos.to_local().fill_(S - 1)
    arg_bytes += 2 * shard_bytes(meta((B,), torch.int64), tspec, sizes)
    # the cache is written in place: the new output is the logits
    return (lambda: model_mod.decode_step(model, token, cache, pos)[0]), \
        arg_bytes


def _local_bytes(tree) -> int:
    from torch.utils._pytree import tree_flatten
    from repro_torch.sharding.local import is_dtensor
    n = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            t = t.to_local() if is_dtensor(t) else t
            n += t.numel() * t.element_size()
    return n


def measure(step, time_limit=None):
    """Run ``step`` once under ``DeviceCostMode``: (outputs, cost mode);
    ``cost.peak`` is the step's peak of live local storage."""
    from torch.distributed.tensor.experimental import implicit_replication
    cost = comm_analysis.DeviceCostMode(time_limit)
    with implicit_replication(), cost:
        out = step()
    return out, cost


def _combo_cfg(arch, shape, opts, cfg=None):
    base = cfg if cfg is not None else configs.get_config(arch)
    cfg = for_shape(base, shape)
    if opts.kv_int8 and shape.kind == "decode" and not cfg.is_mla:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    return base, cfg


def skip_reason(cfg, shape):
    """The reference's skip rules for an adapted config: the reason a
    combination is skipped, or None."""
    ok, why = supports_shape(cfg, shape)
    if not ok:
        return why
    if not (not shape.long_context or cfg.sub_quadratic):
        return "full attention at 500k (DESIGN.md long_500k policy)"
    return None


def default_fsdp(base, shape) -> bool:
    """FSDP when even fully-model-sharded AdamW state would not fit."""
    return shape.kind == "train" and base.param_count() > 50e9


def run_combo(arch: str, shape_name: str, multi_pod: bool = False,
              out_dir: str = None, fsdp=None, *, device: str = "cuda",
              opts: Options = Options(), cfg=None, mesh_shape=None,
              spec=None, time_limit=None) -> dict:
    """One combination's record (written to ``out_dir`` when given).
    ``cfg`` / ``mesh_shape`` / ``spec`` replace the registered config,
    the production mesh and the input shape (the tests' smoke variants
    on small fake meshes).  ``time_limit``: seconds the step's trace may
    take before it is recorded as an error (None: no limit)."""
    shape = spec if spec is not None else INPUT_SHAPES[shape_name]
    base, cfg = _combo_cfg(arch, shape, opts, cfg)
    mname = mesh_name(multi_pod, mesh_shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mname,
           "kind": shape.kind, "batch": shape.batch, "seq": shape.seq,
           "attention": cfg.attention, "device": str(device),
           "params_total": base.param_count(),
           "params_active": base.param_count(active_only=True)}

    def _dump(r):
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{arch}_{shape_name}_{mname}"
                                   ".json"), "w") as f:
                json.dump(r, f, indent=1, default=str)
        return r

    why = skip_reason(cfg, shape)
    if why is not None:
        rec["status"] = "skipped"
        rec["reason"] = why
        return _dump(rec)
    if fsdp is None:
        fsdp = default_fsdp(base, shape)
    rec["fsdp"] = bool(fsdp)
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode
        t0 = time.time()
        mesh, axes = _mesh(multi_pod, mesh_shape, device)
        rec["n_chips"] = int(mesh.size())
        rec["levers"] = _set_levers(cfg, shape, mesh, axes, fsdp, opts)
        with FakeTensorMode():
            step, arg_bytes = build_step(cfg, shape, mesh, axes, fsdp, opts,
                                         device)
            out, cost = measure(step, time_limit)
        out_bytes, peak = _local_bytes(out), cost.peak
        rec["trace_s"] = round(time.time() - t0, 1)
        rec["memory"] = {"argument_bytes": arg_bytes,
                         "output_bytes": out_bytes,
                         "temp_bytes": max(peak - out_bytes, 0),
                         "peak_per_device": arg_bytes + peak}
        rec["cost"] = {"flops": cost.flops,
                       "bytes accessed": cost.bytes_accessed}
        rec["collectives"] = comm_analysis.collective_summary(cost)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 -- record the failure, keep going
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        _reset_levers()
    return _dump(rec)


def run_rank0(arch: str, shape_name: str, multi_pod: bool = False, *,
              device: str = "cuda", opts: Options = Options(), seed: int = 0,
              fsdp=None, cfg=None, mesh_shape=None, spec=None,
              time_reps: int = 1):
    """Rank 0's step for real on ``device`` under the same fake group:
    {"mem_rise": max_memory_allocated over what was allocated before the
    model was built, "flops", "collectives", "ms": the local step's time
    by CUDA events (compute without communication)}."""
    shape = spec if spec is not None else INPUT_SHAPES[shape_name]
    base, cfg = _combo_cfg(arch, shape, opts, cfg)
    if fsdp is None:
        fsdp = default_fsdp(base, shape)
    mesh, axes = _mesh(multi_pod, mesh_shape, device)
    _set_levers(cfg, shape, mesh, axes, fsdp, opts)
    try:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=device).manual_seed(seed)
        step, arg_bytes = build_step(cfg, shape, mesh, axes, fsdp, opts,
                                     device, filler=_Filler(gen, cfg.vocab))
        torch.cuda.synchronize()
        args_measured = torch.cuda.memory_allocated() - before
        _, cost = measure(step)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - before
        from torch.distributed.tensor.experimental import \
            implicit_replication
        times = []
        for _ in range(time_reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            with implicit_replication():
                a.record()
                step()
                b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return {"mem_rise": rise, "args_allocated": args_measured,
                "argument_bytes": arg_bytes, "flops": cost.flops,
                "collectives": comm_analysis.collective_summary(cost),
                "ms": times}
    finally:
        _reset_levers()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the branch the model code traces (cuda: the "
                         "card's in-place cache reads; cpu)")
    ap.add_argument("--seq-shard-kv", action="store_true")
    ap.add_argument("--shard-acts", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--moe-groups", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--time-limit", type=float, default=None,
                    help="seconds one combination's trace may take "
                         "(recorded as an error past it)")
    args = ap.parse_args(argv)
    opts = Options(seq_shard_kv=args.seq_shard_kv,
                   shard_acts=args.shard_acts,
                   seq_parallel=args.seq_parallel,
                   moe_groups=args.moe_groups, kv_int8=args.kv_int8)

    archs = configs.ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mname = mesh_name(mp)
                path = os.path.join(args.out, f"{arch}_{shape}_{mname}.json")
                if args.skip_existing and os.path.exists(path):
                    try:
                        with open(path) as f:
                            old = json.load(f)
                        if old.get("status") in ("ok", "skipped"):
                            print(f"[skip] {arch} {shape} {mname}")
                            continue
                    except (OSError, ValueError):
                        pass
                rec = run_combo(arch, shape, mp, args.out,
                                device=args.device, opts=opts,
                                time_limit=args.time_limit)
                msg = rec["status"]
                if rec["status"] == "ok":
                    gb = rec["memory"]["peak_per_device"] / 2**30
                    coll = rec["collectives"]["total_collective_bytes"]
                    msg += (f" peak={gb:.2f}GiB/chip "
                            f"flops={rec['cost']['flops']:.4g} "
                            f"trace={rec['trace_s']}s "
                            f"coll={coll / 2**30:.2f}GiB")
                elif rec["status"] == "error":
                    msg += " " + rec["error"][:200]
                else:
                    msg += " " + rec.get("reason", "")
                print(f"[{arch} | {shape} | {mname}] {msg}", flush=True)


if __name__ == "__main__":
    main()
