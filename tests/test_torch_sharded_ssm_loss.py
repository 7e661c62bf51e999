"""The port's sharded train-step loss head and SSM mixers on 8 gloo
processes as a (2, 4) ("data", "model") mesh (one spawn for the whole
file), against the single-device port and, for the mixers, the
reference's ``repro.models.ssm`` on the same (bridged) parameters.

- The vocab-parallel cross entropy (``sharding.local.nll_last``): a
  smoke ``qwen2.5-3b`` train step's loss and every parameter gradient,
  with the vocabulary divisible by the model axis (sharded: 512) and not
  (replicated: 510), equal the unsharded port's within 1e-5 relative.
- Mamba, mLSTM and sLSTM on their ``model`` shard (``ssm._sharded``):
  the sequence form from a state, the decode step (one position from a
  state), the prefill (from zeros) and the train form with its input
  and weight gradients, equal the single-device mixers within the SSM
  tests' tolerance; the new states come back in the cache's placements.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DATA, N_MODEL = 2, 4
LOSS_RTOL = 1e-5
ATOL = 2e-5                         # tests/test_torch_ssm.py's
B, S = 2, 6
KINDS = ("mamba", "mlstm", "slstm")
ARCH = {"mamba": "jamba-1.5-large-398b", "mlstm": "xlstm-1.3b",
        "slstm": "xlstm-1.3b"}
# tests/test_torch_ssm.py's reduced widths, the head dims split by 4
OVER = {"mamba": dict(d_model=64, mamba_dt_rank=8),
        "mlstm": dict(d_model=64, n_heads=2, head_dim=32),
        "slstm": dict(d_model=64, n_heads=2, head_dim=32)}
INIT = {"mamba": jssm.init_mamba, "mlstm": jssm.init_mlstm,
        "slstm": jssm.init_slstm}
VOCABS = (512, 510)
FORMS = ("seq", "step", "prefill", "train")

WORKER = r'''
import pickle, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import bridge
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as tmodel, ssm
from repro_torch.sharding.local import laid_out_as
from repro_torch.sharding.partition import MeshAxes, Partitioner, to_placements

rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=8)
mesh = make_debug_mesh(2, 4)
d = pickle.load(open(path, "rb"))
out = {}


def dist_param(prm, spec, grad):
    return torch.nn.Parameter(distribute_tensor(
        prm.detach(), mesh, to_placements(spec, mesh)), requires_grad=grad)


def rows(a):
    return distribute_tensor(torch.from_numpy(a), mesh,
                             [Shard(0), Replicate()])


with implicit_replication():
    for V, (cfg, params, tokens) in d["loss"].items():
        model = bridge.from_jax(params, cfg, device="cpu", trainable=True)
        part = Partitioner(cfg, mesh, MeshAxes())
        owners = {id(p): (m, n) for m in model.modules()
                  for n, p in m.named_parameters(recurse=False)}
        specs = part.param_specs(model)
        for prm, p_, spec in specs:
            mod, name = owners[id(prm)]
            setattr(mod, name, dist_param(prm, spec, True))
        loss, _ = tmodel.train_loss(model, {"tokens": rows(tokens)})
        loss.backward()
        out[("loss", V)] = loss.detach().full_tensor().numpy()
        out[("grads", V)] = [
            laid_out_as(prm.grad, prm).full_tensor().numpy()
            for prm, _ in bridge.leaves(model)]
    for kind, (cfg, params, x, state, probe) in d["mixers"].items():
        part = Partitioner(cfg, mesh, MeshAxes())
        m = ssm.MIXERS[kind](cfg, torch.float32, "cpu")
        for name in params:
            full = torch.from_numpy(params[name])
            spec = part.param_spec(("body", "p0", kind, name, 0),
                                   tuple(full.shape))
            setattr(m, name, dist_param(full, spec, True))
        cspec = part.cache_specs([state])[0]
        st = {k: distribute_tensor(torch.from_numpy(v), mesh,
                                   to_placements(cspec[k], mesh))
              for k, v in state.items()}
        xs = rows(x)
        with torch.no_grad():
            for form, xi, s0 in (("seq", xs, st), ("step", xs[:, :1], st),
                                 ("prefill", xs, None)):
                o, new, _ = ssm.seq(cfg, kind, m, xi, s0)
                out[(kind, form)] = (o.full_tensor().numpy(), {
                    k: v.full_tensor().numpy() for k, v in new.items()})
                if s0 is not None:
                    out[(kind, form, "placements")] = all(
                        new[k].placements == st[k].placements for k in st)
        xg = rows(x).detach().requires_grad_()
        o = ssm.train_seq(cfg, kind, m, xg)
        (o * rows(probe)).sum().backward()
        out[(kind, "train")] = (o.full_tensor().detach().numpy(), {
            "x": xg.grad.full_tensor().numpy(), **{
                n: laid_out_as(getattr(m, n).grad, getattr(m, n))
                .full_tensor().numpy()
                for n in params if getattr(m, n).grad is not None}})
if rank == 0:
    pickle.dump(out, open(path + ".out", "wb"))
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _loss_case(V):
    jc = dataclasses.replace(jconfigs.smoke_variant(
        jconfigs.get_config("qwen2.5-3b")), vocab=V)
    tc = dataclasses.replace(configs.smoke_variant(
        configs.get_config("qwen2.5-3b")), vocab=V)
    params = jax.tree.map(np.asarray, jmodel.init_params(
        jc, jax.random.PRNGKey(V)))
    tokens = np.random.default_rng(V).integers(0, V, (4, 17))
    return tc, params, tokens


def _mixer_case(kind):
    jc = dataclasses.replace(jconfigs.smoke_variant(
        jconfigs.get_config(ARCH[kind])), **OVER[kind])
    tc = dataclasses.replace(configs.smoke_variant(
        configs.get_config(ARCH[kind])), **OVER[kind])
    params = {k: np.array(v, np.float32) for k, v in INIT[kind](
        jax.random.PRNGKey(3), jc).items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32) * 0.5
    st = {k: np.asarray(v) for k, v in ssm.make_state(
        tc, kind, B, torch.float32, "cpu").items()}
    state = {}
    for name, a in st.items():
        r = rng.standard_normal(a.shape).astype(np.float32)
        state[name] = (r * 0.3 if name != "n" else np.abs(r) + 0.5) \
            if name != "m" else r * 0.1
    probe = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    return jc, tc, params, x, state, probe


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The single-device port's (and the reference's) results, and the
    8 gloo ranks' gathered ones."""
    loss = {V: _loss_case(V) for V in VOCABS}
    mixers = {k: _mixer_case(k) for k in KINDS}
    path = str(tmp_path_factory.mktemp("gloo") / "in.pkl")
    with open(path, "wb") as f:
        pickle.dump({"loss": loss, "mixers": {
            k: (tc, p, x, st, pr) for k, (_, tc, p, x, st, pr)
            in mixers.items()}}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), port, path], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(N_DATA * N_MODEL)]
    outs = [pr.communicate(timeout=240)[0] for pr in procs]
    assert all(pr.returncode == 0 for pr in procs), \
        ([o for o in outs if "Error" in o] or outs)[0][-5000:]
    with open(path + ".out", "rb") as f:
        got = pickle.load(f)
    return loss, mixers, got


def _single(kind, tc, params, x, state, probe, form):
    """The single-device port: (out, state or grads) as numpy."""
    m = ssm.MIXERS[kind](tc, torch.float32, "cpu")
    with torch.no_grad():
        for name, a in params.items():
            getattr(m, name).copy_(torch.from_numpy(a))
    xt = torch.from_numpy(x)
    st = {k: torch.from_numpy(v) for k, v in state.items()}
    if form == "train":
        m.requires_grad_(True)
        xg = xt.clone().requires_grad_()
        o = ssm.train_seq(tc, kind, m, xg)
        (o * torch.from_numpy(probe)).sum().backward()
        return o.detach().numpy(), {"x": xg.grad.numpy(), **{
            n: getattr(m, n).grad.numpy() for n in params
            if getattr(m, n).grad is not None}}
    with torch.no_grad():
        xi, s0 = {"seq": (xt, st), "step": (xt[:, :1], st),
                  "prefill": (xt, None)}[form]
        o, new, _ = ssm.seq(tc, kind, m, xi, s0)
    return o.numpy(), {k: v.numpy() for k, v in new.items()}


@pytest.mark.parametrize("V", VOCABS)
def test_vocab_parallel_loss_and_grads_equal_unsharded(run, V):
    loss, _, got = run
    tc, params, tokens = loss[V]
    model = bridge.from_jax(params, tc, device="cpu", trainable=True)
    ref, _ = tmodel.train_loss(model, {"tokens": torch.from_numpy(tokens)})
    ref.backward()
    np.testing.assert_allclose(got[("loss", V)], ref.detach().numpy(),
                               rtol=LOSS_RTOL)
    leaves = bridge.leaves(model)
    assert len(got[("grads", V)]) == len(leaves)
    for g, (prm, path) in zip(got[("grads", V)], leaves):
        want = prm.grad.numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(g - want).max()) <= LOSS_RTOL * scale, path


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_mixer_equals_single_device(run, kind, form):
    _, mixers, got = run
    jc, tc, params, x, state, probe = mixers[kind]
    want_out, want = _single(kind, tc, params, x, state, probe, form)
    out, leaves = got[(kind, form)]
    np.testing.assert_allclose(out, want_out, atol=ATOL)
    assert sorted(leaves) == sorted(want), (sorted(leaves), sorted(want))
    for name in want:
        tol = ATOL * max(1.0, float(np.abs(want[name]).max()))
        np.testing.assert_allclose(leaves[name], want[name], atol=tol,
                                   err_msg=name)
    if form in ("seq", "step"):
        assert got[(kind, form, "placements")]
        # the reference on the same parameters, state and input
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        js = {k: jnp.asarray(v) for k, v in state.items()}
        if form == "seq":
            fn = {"mamba": jssm.mamba_seq, "mlstm": jssm.mlstm_seq_recurrent,
                  "slstm": jssm.slstm_seq}[kind]
            ref, _ = fn(jc, jp, jnp.asarray(x), state=js, return_state=True)
        else:
            fn = {"mamba": jssm.mamba_step, "mlstm": jssm.mlstm_step,
                  "slstm": jssm.slstm_step}[kind]
            ref, _ = fn(jc, jp, jnp.asarray(x[:, :1]), js)
        np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
