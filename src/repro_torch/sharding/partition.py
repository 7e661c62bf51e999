"""Partitioning rules: parameters, optimizer state, caches and batches to
per-tensor specs for the production mesh (mirrors
``repro.sharding.partition``).

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry
per tensor dim, a mesh axis name, a tuple of names (sharded over their
product, the first major) or None (replicated).  ``to_placements`` turns
one into DTensor placements on a ``DeviceMesh``, and ``distribute``
turns a port model's parameters into DTensor parameters by those
placements.

Axis conventions:
  "data"  batch (training, prefill, decode) or the KV cache's sequence
          (context parallelism: long_500k decode at batch 1);
  "model" vocab, attention heads, FFN hidden, experts, SSM channels;
  "pod"   the outer data axis (multi-pod).

Every rule guards divisibility: a dim is sharded only when its size is a
multiple of the mesh axis; otherwise it falls back (replicate, or shard
another dim: qwen2-moe's 60 experts do not divide 16, so its expert
weights shard the per-expert FFN dim instead).

Rules are keyed by the reference's leaf paths (``bridge.leaves``).  The
port holds one tensor a layer where the reference stacks a body's periods
(``body/...``) or an encoder's layers (``encoder/...``) on a leading
axis, so a port spec is the reference's without that axis.  FSDP shards
the first replicated dim that divides over the data axes: on a stacked
leaf the reference may pick the stacking axis (qwen2-vl-72b's 80 layers
on the 16 x 16 mesh), where the port picks the first such dim of the
layer's own shape; the bytes a device holds are the same.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    model: str = "model"
    pod: Optional[str] = None          # set for multi-pod meshes

    @property
    def dp(self):
        """Composite data-parallel axes (pod-major)."""
        return (self.pod, self.data) if self.pod else (self.data,)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of any object with a
    ``shape`` dict, as the tests' size-only meshes)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def _names(path):
    """The string keys of a ``bridge.leaves`` path (the layer index of a
    stacked leaf dropped)."""
    return [k for k in path if not isinstance(k, int)]


class Partitioner:
    def __init__(self, cfg: ModelConfig, mesh, axes: MeshAxes,
                 fsdp: bool = False, seq_shard_fallback: bool = False):
        """seq_shard_fallback: when the KV heads do not divide the model
        axis, shard the cache's sequence over ``model`` (flash-decoding
        style) instead of replicating the cache on every model rank."""
        self.cfg, self.mesh, self.axes, self.fsdp = cfg, mesh, axes, fsdp
        self.seq_fallback = seq_shard_fallback
        self.sizes = mesh_sizes(mesh)
        self.M = self.sizes[axes.model]
        self.D = _size(self.sizes, axes.dp)

    # -- helpers --------------------------------------------------------
    def _m(self, dim: int):
        return self.axes.model if dim % self.M == 0 else None

    def _dp(self, dim: int):
        return self.axes.dp if dim % self.D == 0 else None

    # -- parameter rules -------------------------------------------------
    def _param_rule(self, names, shape):
        name = names[-1]
        parent = names[-2] if len(names) > 1 else ""
        core = tuple(shape)

        def spec(*s):
            return tuple(s)

        if name == "embedding":
            return spec(self._m(core[0]), None)
        if name == "lm_head":
            return spec(None, self._m(core[1]))
        if parent in ("mlstm",) and name in ("w_q", "w_k", "w_v"):
            return spec(None, None, self._m(core[2]))        # (nh, dh, dh)
        if name in ("w_q",):                                  # (d, nq, hd)
            return spec(None, self._m(core[1]), None)
        if name in ("w_uk", "w_uv"):                          # (rank, nq, hd)
            return spec(None, self._m(core[1]), None)
        if name in ("w_k", "w_v"):                            # (d, nkv, hd)
            return spec(None, self._m(core[1]), None)
        if name in ("b_q", "b_k", "b_v"):                     # (n, hd)
            return spec(self._m(core[0]), None)
        if name == "w_o":                                     # (nq, hd, d)
            return spec(self._m(core[0]), None, None)
        if name in ("w_dkv", "w_krope", "router"):
            return spec(*([None] * len(core)))
        if name in ("w_gate", "w_up"):
            if len(core) == 3:                                # (E, d, f)
                e = self._m(core[0])
                return spec(e, None, None if e else self._m(core[2]))
            return spec(None, self._m(core[1]))               # (d, ff)
        if name == "w_down":
            if len(core) == 3:                                # (E, f, d)
                e = self._m(core[0])
                return spec(e, None if e else self._m(core[1]), None)
            return spec(self._m(core[0]), None)               # (ff, d)
        if name in ("in_proj", "up_proj", "ffn_up", "w_in", "dt_proj"):
            return spec(None, self._m(core[1]))
        if name in ("out_proj", "down_proj", "ffn_down", "x_proj"):
            return spec(self._m(core[0]), None)
        if name in ("conv_w",):                               # (K, di)
            return spec(None, self._m(core[1]))
        if name in ("conv_b", "dt_bias", "D",):               # (di,)
            return spec(self._m(core[0]))
        if name == "A_log":                                   # (di, ds)
            return spec(self._m(core[0]), None)
        if name in ("w_i", "w_f"):                            # (di, nh)
            return spec(self._m(core[0]), None)
        if name == "r":                                       # (4, nh, dh, dh)
            return spec(None, None, None, self._m(core[3]))
        if name == "norm_w" and parent == "mlstm":
            return spec(self._m(core[0]))
        # norms, biases, gates, scalars -> replicated
        return spec(*([None] * len(core)))

    def param_spec(self, path, shape):
        """One leaf's spec from its ``bridge.leaves`` path and its port
        shape."""
        s = list(self._param_rule(_names(path), shape))
        if self.fsdp:
            # shard the first replicated dim over data (ZeRO-3 style)
            for i, ax in enumerate(s):
                if ax is None and shape[i] % self.D == 0 \
                        and shape[i] >= self.D:
                    s[i] = self.axes.dp
                    break
        return tuple(s)

    def param_specs(self, model):
        """[(parameter, path, spec)] in ``bridge.leaves`` order."""
        from repro_torch.bridge import leaves
        return [(prm, path, self.param_spec(path, prm.shape))
                for prm, path in leaves(model)]

    def opt_state_specs(self, model):
        """The AdamW state's specs: m and v as the parameters (in
        ``leaves`` order), the step replicated."""
        ps = [s for _, _, s in self.param_specs(model)]
        return {"m": ps, "v": ps, "step": ()}

    # -- cache rules ------------------------------------------------------
    def _cache_rule(self, name, core, shard_seq):
        if name in ("k", "v", "cross_k", "cross_v"):   # (B, S, nkv, hd)
            if shard_seq:
                return (None, self.axes.dp, self._m(core[2]), None)
            mh = self._m(core[2])
            if mh is None and self.seq_fallback and core[1] % self.M == 0:
                # kv heads indivisible -> shard seq over model instead
                return (self._dp(core[0]), self.axes.model, None, None)
            return (self._dp(core[0]), None, mh, None)
        if name in ("k_scale", "v_scale"):             # (B, S, nkv)
            if shard_seq:
                return (None, self.axes.dp, self._m(core[2]))
            mh = self._m(core[2])
            if mh is None and self.seq_fallback and core[1] % self.M == 0:
                return (self._dp(core[0]), self.axes.model, None)
            return (self._dp(core[0]), None, mh)
        if name in ("latent", "k_rope"):               # (B, S, rank)
            if shard_seq:
                return (None, self.axes.dp, None)
            if self.seq_fallback and core[1] % self.M == 0:
                return (self._dp(core[0]), self.axes.model, None)
            return (self._dp(core[0]), None, None)
        if name == "conv":                             # (B, K-1, di)
            return (self._dp(core[0]), None, self._m(core[2]))
        if name == "ssm":                              # (B, di, ds)
            return (self._dp(core[0]), self._m(core[1]), None)
        if name == "C":                                # (B, nh, dh, dh)
            return (self._dp(core[0]), None, None, self._m(core[3]))
        if name == "n" and len(core) == 3:
            return (self._dp(core[0]), None, self._m(core[2]))
        if name in ("h", "c", "n", "m") and len(core) == 2:
            return (self._dp(core[0]), self._m(core[1]))
        return tuple([self._dp(core[0])] + [None] * (len(core) - 1))

    def cache_specs(self, cache, shard_seq: bool = False):
        """cache: the port's list of per-layer dicts (``init_cache``) ->
        the same list of {leaf: spec}.  shard_seq=True: context
        parallelism, the KV sequence over the data axes (long_500k at
        batch 1).  A layer's cross K/V take the reference's ``cross``
        rule, its KV's."""
        return [{name: self._cache_rule(name, tuple(t.shape), shard_seq)
                 for name, t in c.items()} for c in cache]

    # -- batch rules ------------------------------------------------------
    def batch_specs(self, batch):
        """batch: {name: tensor} -> {name: spec}; (3, B, S) M-RoPE
        positions shard their batch axis, 1."""
        out = {}
        for name, t in batch.items():
            shape = tuple(t.shape)
            if name == "positions" and len(shape) == 3:      # (3, B, S)
                out[name] = (None, self._dp(shape[1]), None)
                continue
            b = self._dp(shape[0]) if shape else None
            out[name] = tuple([b] + [None] * (len(shape) - 1)) \
                if shape else ()
        return out


# ----------------------------------------------------------------------
# DTensor
# ----------------------------------------------------------------------
def to_placements(spec, mesh):
    """A spec -> DTensor placements, one a mesh dim: ``Shard(i)`` on every
    mesh dim of more than one rank named by entry i (a tuple such as
    ``("pod", "data")`` shards dim i over both, the first major,
    DTensor's order for one tensor dim over several mesh dims),
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            m = names.index(a)
            # a mesh dim of one rank shards nothing: replicated, so views
            # that merge the dim stay legal
            if mesh.size(m) > 1:
                out[m] = Shard(i)
    return out


def local_shape(shape, spec, sizes: dict):
    """The shape of one device's shard of a tensor of ``shape`` under
    ``spec`` (every sharded dim divides, as the rules guard)."""
    return tuple(n // _size(sizes, ax) for n, ax in zip(shape, spec))


def shard_bytes(t, spec, sizes: dict) -> int:
    n = 1
    for d in local_shape(t.shape, spec, sizes):
        n *= d
    return n * t.element_size()


def dtensor_like(t, spec, mesh, local=None):
    """A DTensor of ``t``'s global shape and dtype on ``mesh`` under
    ``spec``, whose local shard is ``local`` (default: an empty tensor on
    ``t``'s device, made under whatever mode is active, so a fake tensor
    under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    if local is None:
        local = torch.empty(local_shape(t.shape, spec, mesh_sizes(mesh)),
                            dtype=t.dtype, device=t.device)
    return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                              run_check=False, shape=tuple(t.shape),
                              stride=torch.empty(tuple(t.shape),
                                                 device="meta").stride())


def distribute(model, part: Partitioner, device=None, fill=None):
    """Replace every parameter of a port model (built on any device,
    ``meta`` included) by a DTensor parameter under its
    ``part.param_specs`` placements, the local shard on ``device`` (the
    parameter's own by default).  ``fill(local, path)`` fills a local
    shard in place (default: left empty, as a fake tensor or for a
    shape-only run).  Gradients stay as they were on each parameter.
    Returns the model."""
    from torch import nn
    mesh, sizes = part.mesh, part.sizes
    owners = {}
    for mod in model.modules():
        for pname, prm in mod.named_parameters(recurse=False):
            owners[id(prm)] = (mod, pname)
    for prm, path, spec in part.param_specs(model):
        dev = device if device is not None else prm.device
        local = torch.empty(local_shape(prm.shape, spec, sizes),
                            dtype=prm.dtype, device=dev)
        if fill is not None:
            with torch.no_grad():
                fill(local, path)
        mod, pname = owners[id(prm)]
        dt = dtensor_like(prm, spec, mesh, local=local)
        setattr(mod, pname, nn.Parameter(dt, requires_grad=prm.requires_grad))
    return model
