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
parameters, which the serve path's gradient-free parameters refuse;
``peak_extrapolated``); ``cost`` (``flops``, ``bytes accessed``:
``comm_analysis``'s counts of the local ops); ``collectives`` (with
``whole_mixer_gathers``: all-gathers that bring an SSM mixer's large
projection or a recurrent state whole over ``model``, 0 by design);
``n_chips``; and ``trace_s`` in place of ``lower_s`` / ``compile_s``.

Calibration, the reference's ``--calibrate``: the port's layers and the
SSM mixers' position loops are Python loops that every trip dispatches,
and a whole trace of the longest combinations (xLSTM's recurrent prefill
over 32768 positions) takes tens of minutes.  ``calibrated_counts``
traces ``CAL_UNITS`` units (body periods and encoder layers, as the
reference's ``_reduced_cfg``), dispatches two trips of each position
loop (four with gradients) and multiplies, traces a train step's AdamW
update on the whole config's parameters, and extrapolates: FLOPs, bytes
and collectives equal a whole trace exactly, and the peak is marked
``peak_extrapolated``.  The record carries ``scan_calibration``
(``n_units``, ``cost_1p`` / ``cost_2p``, the ``update``) and
``calibration_status``.  ``--calibrate auto`` (the default) calibrates
the combinations ``needs_calibration`` names.

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
from repro_torch.models import ssm as ssm_mod
from repro_torch.sharding import act_sharding
from repro_torch.sharding.partition import (MeshAxes, Partitioner,
                                            distribute, dtensor_like,
                                            local_shape, mesh_sizes,
                                            shard_bytes)
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import (decay_mask, loss_and_grads,
                                       make_train_step, parameters)

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
               filler=None, part=None):
    """(step thunk, argument bytes) for one rank of ``mesh``; under
    ``FakeTensorMode`` when ``filler`` is None (the caller enters it).
    ``part`` splits a train step (a calibrated count): "grads", the loss
    and gradients (``trainer.loss_and_grads``), or "update", AdamW on
    gradients made before the thunk runs; None is the whole step."""
    rules = Partitioner(cfg, mesh, axes, fsdp=fsdp,
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
    specs = rules.param_specs(model)
    arg_bytes = sum(shard_bytes(prm, s, sizes) for prm, _, s in specs)
    distribute(model, rules, device=device, fill=fill)

    def inputs(batch):
        bspec = rules.batch_specs(batch)
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
        ospec = rules.opt_state_specs(model)
        arg_bytes += sum(shard_bytes(prm, s, sizes) for key in ("m", "v")
                         for prm, s in zip(params, ospec[key]))
        batch = {"tokens": meta((B, S + 1), torch.int64)}
        if cfg.n_encoder_layers:
            batch["enc_embeds"] = meta((B, ENC_LEN, cfg.d_model),
                                       model.dtype)
        batch, nb = inputs(batch)
        arg_bytes += nb
        if part == "grads":
            def grads():
                loss, mets, g = loss_and_grads(model, batch)
                return dict(mets, loss=loss), g
            return grads, arg_bytes
        if part == "update":
            g = [torch.zeros_like(p) for p in params]

            def update():
                return opt_mod.apply_updates(opt_mod.AdamWConfig(), params,
                                             g, opt_state,
                                             decay_mask(model))[2]
            update.grads = g
            return update, arg_bytes
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
    cspec = rules.cache_specs(cache_meta, shard_seq=shape.long_context)
    cache = [{n: _local_input(t, cspec[i][n], mesh, device)
              for n, t in c.items()} for i, c in enumerate(cache_meta)]
    arg_bytes += sum(shard_bytes(t, cspec[i][n], sizes)
                     for i, c in enumerate(cache_meta)
                     for n, t in c.items())
    tspec = (rules._dp(B),)
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


def measure(step, time_limit=None, multiply_trips: bool = False):
    """Run ``step`` once under ``DeviceCostMode``: (outputs, cost mode);
    ``cost.peak`` is the step's peak of live local storage.
    ``multiply_trips``: the SSM mixers' position loops dispatch two trips
    and multiply (``models.ssm._loop``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    cost = comm_analysis.DeviceCostMode(time_limit)
    if multiply_trips:
        ssm_mod.POSITION_LOOP = cost
    try:
        with implicit_replication(), cost:
            out = step()
    finally:
        ssm_mod.POSITION_LOOP = None
    return out, cost


def n_units(cfg) -> int:
    """The repeated units of a config: body periods (and encoder layers),
    as the reference's ``calibrate_combo`` counts them."""
    return max(cfg.n_periods, cfg.n_encoder_layers, 1)


def _reduced_cfg(cfg, n: int):
    """The same arch with n body periods (and encoder layers), as the
    reference's."""
    return dataclasses.replace(
        cfg, n_layers=cfg.n_prefix_layers + n * cfg.period,
        n_encoder_layers=min(cfg.n_encoder_layers, n)
        if cfg.n_encoder_layers else 0)


# the units traced for a calibrated count (the reference traces 0 and 1:
# from 1 on every traced step holds a unit's own temporaries, so the live
# peak, like the counts, grows by the same amount a unit)
CAL_UNITS = (1, 2)


# an SSM mixer's leaves that a rank never gathers whole over ``model``
# (each mixer runs on its shard), and its recurrent states (all but
# mLSTM's stabiliser m, one float a head, which every rank reads whole)
LARGE_MIXER_LEAVES = ("in_proj", "up_proj", "down_proj", "out_proj",
                      "x_proj", "w_in", "ffn_up", "ffn_down")
STATE_LEAVES = ("conv", "ssm", "C", "n", "h", "c")


def whole_over_model(cfg, shape, mesh, axes) -> set:
    """The result shapes an all-gather over ``model`` would have if it
    brought a large SSM mixer projection (as the mixer gets it: sharded
    over ``model`` only) or a recurrent state (rows over the data axes)
    together: the local shards stacked on dim 0, as DTensor gathers."""
    sizes = mesh_sizes(mesh)
    M = sizes[axes.model]
    rules = Partitioner(cfg, mesh, axes)
    model = model_mod.Transformer(cfg, device="meta")

    def stacked(shp, spec):
        if axes.model not in spec:
            return None
        local = local_shape(shp, spec, sizes)
        return (local[0] * M,) + tuple(local[1:])

    out = set()
    for prm, path, spec in rules.param_specs(model):
        if len(path) > 2 and path[-2] in LARGE_MIXER_LEAVES and \
                path[-3] in ssm_mod.MIXERS:
            out.add(stacked(prm.shape, spec))
    if shape.kind != "train":
        cache = model_mod.init_cache(model, shape.batch, shape.seq)
        for layer, specs in zip(cache, rules.cache_specs(
                cache, shard_seq=shape.long_context)):
            names = STATE_LEAVES + (("m",) if "h" in layer else ())
            for name in names:
                if name in layer and layer[name].ndim >= 2:
                    out.add(stacked(layer[name].shape, specs[name]))
    out.discard(None)
    return out


def _counted(arg_bytes, out, cost, forbidden=frozenset()) -> dict:
    out_bytes = _local_bytes(out)
    coll = comm_analysis.collective_summary(cost)
    coll["whole_mixer_gathers"] = sum(s in forbidden for s in cost.gathered)
    return {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "live_peak": cost.peak, "flops": cost.flops,
            "bytes accessed": cost.bytes_accessed, "collectives": coll}


def _summed(a: dict, b: dict) -> dict:
    """The counts of a step run as part a then part b, what a leaves
    alive held through b."""
    ca, cb = a["collectives"], b["collectives"]
    kinds = set(ca["per_kind_bytes"]) | set(cb["per_kind_bytes"])
    per_b = {k: ca["per_kind_bytes"].get(k, 0) + cb["per_kind_bytes"]
             .get(k, 0) for k in kinds}
    per_c = {k: ca["per_kind_count"].get(k, 0) + cb["per_kind_count"]
             .get(k, 0) for k in kinds}
    coll = {"total_collective_bytes": float(sum(per_b.values())),
            "per_kind_bytes": per_b, "per_kind_count": per_c,
            "whole_mixer_gathers": ca["whole_mixer_gathers"]
            + cb["whole_mixer_gathers"]}
    return {"argument_bytes": a["argument_bytes"],
            "output_bytes": a["output_bytes"] + b["output_bytes"],
            "live_peak": max(a["live_peak"], a["live_end"] + b["live_peak"]),
            "flops": a["flops"] + b["flops"],
            "bytes accessed": a["bytes accessed"] + b["bytes accessed"],
            "collectives": coll}


def _extrapolated(c0: dict, c1: dict, n0: int, n1: int, N: int) -> dict:
    """Each count at N units, linear through its values at n0 and n1
    units (exact for FLOPs, bytes and collectives: every unit dispatches
    the same ops)."""
    def lin(a, b):
        return b + (N - n1) * (b - a) // (n1 - n0)

    col0, col1 = c0["collectives"], c1["collectives"]
    kinds = set(col0["per_kind_bytes"]) | set(col1["per_kind_bytes"])
    per_b = {k: lin(col0["per_kind_bytes"].get(k, 0),
                    col1["per_kind_bytes"].get(k, 0)) for k in kinds}
    per_c = {k: lin(col0["per_kind_count"].get(k, 0),
                    col1["per_kind_count"].get(k, 0)) for k in kinds}
    return {"output_bytes": lin(c0["output_bytes"], c1["output_bytes"]),
            "live_peak": lin(c0["live_peak"], c1["live_peak"]),
            "live_end": lin(c0["live_end"], c1["live_end"]),
            "flops": lin(c0["flops"], c1["flops"]),
            "bytes accessed": lin(c0["bytes accessed"], c1["bytes accessed"]),
            "collectives": {"total_collective_bytes": float(sum(
                per_b.values())), "per_kind_bytes": per_b,
                "per_kind_count": per_c, "whole_mixer_gathers": lin(
                    col0["whole_mixer_gathers"],
                    col1["whole_mixer_gathers"])}}


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


def needs_calibration(cfg, shape) -> bool:
    """Whether the default dry run counts a combination by calibration
    rather than tracing it whole: a prefill or train step of a config
    with SSM mixers, whose loops over positions (mLSTM's recurrent
    prefill, sLSTM) or over 256-position chunks (Mamba) a whole trace
    dispatches trip by trip (past 10 minutes a combination on the card's
    host, `PERF.md` section 6)."""
    return shape.kind != "decode" and any(b in ssm_mod.MIXERS
                                          for b in cfg.block_pattern)


def default_fsdp(base, shape) -> bool:
    """FSDP when even fully-model-sharded AdamW state would not fit."""
    return shape.kind == "train" and base.param_count() > 50e9


def _trace(cfg, shape, mesh, axes, fsdp, opts, device, time_limit,
           multiply_trips=False, part=None) -> dict:
    """One traced step's counts (``_counted``), with ``live_end``: the
    storage the step made that is still alive after it (a "grads" part's
    gradients, which its output bytes leave out)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        step, arg_bytes = build_step(cfg, shape, mesh, axes, fsdp, opts,
                                     device, part=part)
        out, cost = measure(step, time_limit, multiply_trips)
        return dict(_counted(arg_bytes, out[0] if part == "grads" else out,
                             cost, whole_over_model(cfg, shape, mesh, axes)),
                    live_end=cost.live)


def calibrated_counts(cfg, shape, mesh, axes, fsdp, opts, device,
                      time_limit=None):
    """The step's counts from traces of ``CAL_UNITS`` units (the
    reference's ``calibrate_combo``: body periods and encoder layers
    cut), the position loops' trips multiplied, extrapolated to the
    config's ``n_units``; the arguments are the whole config's.  Returns
    (counts, the record's ``scan_calibration``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    N = n_units(cfg)
    with FakeTensorMode():
        _, arg_bytes = build_step(cfg, shape, mesh, axes, fsdp, opts,
                                  device)
    train = shape.kind == "train"
    cal = {"n_units": N, "position_trips": "multiplied"}
    c = {}
    for n in CAL_UNITS:
        t0 = time.time()
        c[n] = _trace(_reduced_cfg(cfg, n), shape, mesh, axes, fsdp, opts,
                      device, time_limit, multiply_trips=True,
                      part="grads" if train else None)
        cal[f"cost_{n}p"] = dict(c[n], trace_s=round(time.time() - t0, 1))
    out = _extrapolated(c[CAL_UNITS[0]], c[CAL_UNITS[1]], *CAL_UNITS, N)
    out["argument_bytes"] = arg_bytes
    if train:
        # the update's multi-tensor groups do not repeat by unit: traced
        # on the whole config's parameters
        t0 = time.time()
        u = _trace(cfg, shape, mesh, axes, fsdp, opts, device, time_limit,
                   part="update")
        cal["update"] = dict(u, trace_s=round(time.time() - t0, 1))
        out = _summed(out, u)
    return out, cal


def run_combo(arch: str, shape_name: str, multi_pod: bool = False,
              out_dir: str = None, fsdp=None, *, device: str = "cuda",
              opts: Options = Options(), cfg=None, mesh_shape=None,
              spec=None, time_limit=None, calibrate=False) -> dict:
    """One combination's record (written to ``out_dir`` when given).
    ``cfg`` / ``mesh_shape`` / ``spec`` replace the registered config,
    the production mesh and the input shape (the tests' smoke variants
    on small fake meshes).  ``time_limit``: seconds each trace may take
    before it is recorded as an error (None: no limit).  ``calibrate``:
    count the step from traces of ``CAL_UNITS`` units with the position
    loops' trips multiplied (``calibrated_counts``) instead of tracing
    it whole; None decides by ``needs_calibration``."""
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
    if calibrate is None:
        calibrate = needs_calibration(cfg, shape)
    try:
        t0 = time.time()
        mesh, axes = _mesh(multi_pod, mesh_shape, device)
        rec["n_chips"] = int(mesh.size())
        rec["levers"] = _set_levers(cfg, shape, mesh, axes, fsdp, opts)
        if calibrate:
            c, cal = calibrated_counts(cfg, shape, mesh, axes, fsdp, opts,
                                       device, time_limit)
            rec["scan_calibration"] = cal
            rec["calibration_status"] = "ok"
        else:
            c = _trace(cfg, shape, mesh, axes, fsdp, opts, device,
                       time_limit)
        rec["trace_s"] = round(time.time() - t0, 1)
        rec["memory"] = {"argument_bytes": c["argument_bytes"],
                         "output_bytes": c["output_bytes"],
                         "temp_bytes": max(c["live_peak"]
                                           - c["output_bytes"], 0),
                         "peak_per_device": c["argument_bytes"]
                         + c["live_peak"],
                         "peak_extrapolated": bool(calibrate)}
        rec["cost"] = {"flops": c["flops"],
                       "bytes accessed": c["bytes accessed"]}
        rec["collectives"] = c["collectives"]
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
        coll = comm_analysis.collective_summary(cost)
        forbidden = whole_over_model(cfg, shape, mesh, axes)
        coll["whole_mixer_gathers"] = sum(s in forbidden
                                          for s in cost.gathered)
        return {"mem_rise": rise, "args_allocated": args_measured,
                "argument_bytes": arg_bytes, "flops": cost.flops,
                "collectives": coll, "ms": times}
    finally:
        _reset_levers()


def _summary(rec) -> str:
    msg = rec["status"]
    if rec["status"] == "ok":
        gb = rec["memory"]["peak_per_device"] / 2**30
        coll = rec["collectives"]["total_collective_bytes"]
        msg += (f" peak={gb:.2f}GiB/chip"
                + ("(extrapolated)" if rec["memory"]["peak_extrapolated"]
                   else "")
                + f" flops={rec['cost']['flops']:.4g} "
                f"trace={rec['trace_s']}s coll={coll / 2**30:.2f}GiB")
    elif rec["status"] == "error":
        msg += " " + rec["error"][:200]
    else:
        msg += " " + rec.get("reason", "")
    return f"[{rec['arch']} | {rec['shape']} | {rec['mesh']}] {msg}"


def _run_one(job):
    arch, shape, mp, kw = job
    return _summary(run_combo(arch, shape, mp, **kw))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="an arch, or several separated by commas")
    ap.add_argument("--shape", default=None,
                    help="a shape, or several separated by commas")
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
                    help="seconds one trace may take (recorded as an "
                         "error past it)")
    ap.add_argument("--calibrate", default="auto",
                    choices=("auto", "never"),
                    help="count the combinations needs_calibration names "
                         "from traces of CAL_UNITS units with the "
                         "position loops' trips multiplied (auto), or "
                         "trace every combination whole (never)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations traced at once, each in a process "
                         "of its own")
    args = ap.parse_args(argv)
    opts = Options(seq_shard_kv=args.seq_shard_kv,
                   shard_acts=args.shard_acts,
                   seq_parallel=args.seq_parallel,
                   moe_groups=args.moe_groups, kv_int8=args.kv_int8)
    kw = dict(out_dir=args.out, device=args.device, opts=opts,
              time_limit=args.time_limit,
              calibrate=None if args.calibrate == "auto" else False)

    archs = configs.ASSIGNED if (args.all or not args.arch) \
        else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else args.shape.split(",")
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]

    jobs = []
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
                jobs.append((arch, shape, mp, kw))
    if args.jobs <= 1:
        for job in jobs:
            print(_run_one(job), flush=True)
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed
    with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing
                             .get_context("spawn"),
                             max_tasks_per_child=1) as pool:
        for fut in as_completed([pool.submit(_run_one, j) for j in jobs]):
            print(fut.result(), flush=True)


if __name__ == "__main__":
    main()
