"""The port's sharded MoE dispatch (``MoE.mix`` on DTensor weights,
``moe.GROUPS`` dispatch groups) on 8 gloo processes as a (2, 4)
("data", "model") mesh, against the single-device port and the
reference's single-device ``moe_apply`` on the same (bridged)
parameters, in the smoke settings of the reference's own shard-map test
(``tests/test_sharding.py``): 8 experts (sharded over ``model``) and 6
(indivisible by 4: the per-expert FFN dim is sharded instead), top-2, a
shared expert.  The grouped run and the ungrouped one (the token stream
gathered over ``data``) must both agree within 1e-4.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DATA, N_MODEL = 2, 4
TOL = 1e-4

WORKER = r'''
import os, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.sharding import act_sharding
from repro_torch.sharding.partition import MeshAxes, Partitioner, to_placements

rank, port, path, E, groups = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                               int(sys.argv[4]), int(sys.argv[5]))
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=8)
mesh = make_debug_mesh(2, 4)
d = dict(np.load(path))
import pickle
cfg = pickle.loads(d.pop("cfg").tobytes())
m = moe_mod.MoE(cfg, torch.float32, "cpu")
part = Partitioner(cfg, mesh, MeshAxes())
with torch.no_grad():
    for name, prm in list(m.named_parameters()):
        full = torch.from_numpy(d["p/" + name])
        path_ = ("body", "p0", "moe", *name.split("."), 0)
        spec = part.param_spec(path_, tuple(full.shape))
        dt = distribute_tensor(full, mesh, to_placements(spec, mesh))
        mod = m
        *owner, leaf = name.split(".")
        for o in owner:
            mod = getattr(mod, o)
        setattr(mod, leaf, torch.nn.Parameter(dt, requires_grad=False))
x = distribute_tensor(torch.from_numpy(d["x"]), mesh, [Shard(0), Replicate()])
act_sharding.set_mesh(mesh, MeshAxes())
moe_mod.GROUPS = 2 if groups else 1
with torch.no_grad(), implicit_replication():
    y, aux = m.mix(x)
    y = y.full_tensor()
    aux = aux.full_tensor()
if rank == 0:
    np.savez(path + f".out{E}_{groups}.npz", y=y.numpy(), aux=aux.numpy())
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cfgs(E):
    kw = dict(n_experts=E, moe_top_k=2, d_expert=128, n_shared_experts=1,
              capacity_factor=8.0)
    j = dataclasses.replace(jconfigs.smoke_variant(
        jconfigs.get_config("qwen2-moe-a2.7b")), **kw)
    t = dataclasses.replace(configs.smoke_variant(
        configs.get_config("qwen2-moe-a2.7b")), **kw)
    return j, t


def _flat(p, prefix=""):
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("E", [8, 6])
def test_grouped_moe_matches_single_device(tmp_path, E):
    import pickle
    jcfg, tcfg = _cfgs(E)
    p = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (4, 16, jcfg.d_model)) * .3, np.float32)
    y_ref, _ = jmoe.moe_apply(jcfg, p, jnp.asarray(x), dropless=True)
    y_ref = np.asarray(y_ref)
    flat = _flat(p)
    m = MoE(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        for name, prm in m.named_parameters():
            prm.copy_(torch.from_numpy(flat[name]))
        y_one, _ = m.mix(torch.from_numpy(x))
    np.testing.assert_allclose(y_one.numpy(), y_ref, atol=TOL)
    path = str(tmp_path / "moe.npz")
    np.savez(path, x=x, cfg=np.frombuffer(pickle.dumps(tcfg), np.uint8),
             **{"p/" + k: v for k, v in flat.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    for groups in (1, 0):
        port = str(_free_port())
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), port, path, str(E),
             str(groups)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r in range(N_DATA * N_MODEL)]
        outs = [pr.communicate(timeout=100)[0] for pr in procs]
        assert all(pr.returncode == 0 for pr in procs), outs[0][-3000:]
        got = np.load(path + f".out{E}_{groups}.npz")
        err_port = float(np.abs(got["y"] - y_one.numpy()).max())
        err_ref = float(np.abs(got["y"] - y_ref).max())
        assert err_port < TOL and err_ref < TOL, (E, groups, err_port,
                                                  err_ref)
        assert np.isfinite(got["aux"]).all()
