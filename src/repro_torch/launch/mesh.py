"""Production mesh construction (mirrors ``repro.launch.mesh``).

Functions, not module-level constants: importing this module initialises
no process group, sets no environment variable and touches no card.

``make_production_mesh`` is a DRY-RUN mesh: the reference's logical
shapes and axis names, (16, 16) as ("data", "model") and (2, 16, 16) as
("pod", "data", "model"), built as a ``DeviceMesh`` over a fake process
group of 256 / 512 ranks that stands for one rank of the production
cluster.  Its collectives do no communication (their results are not
the sums or gathers a real group would give); DTensor sharding
propagation, the shapes each rank holds, and the collectives the program
issues are exactly those of the real mesh.  ``make_debug_mesh`` builds a
mesh on whatever group is initialised (the tests run real gloo ranks).
"""
from __future__ import annotations

from repro_torch.sharding.partition import MeshAxes

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def fake_group(world_size: int, rank: int = 0):
    """Make the default process group a fake one of ``world_size`` ranks,
    this process being ``rank``.  A fake group already initialised at
    another size is replaced; a real group is never touched (raises).

    The ``fake`` backend is registered by importing
    ``torch.testing._internal.distributed.fake_pg`` (it registers
    ``FakeProcessGroup`` for cpu and cuda on import), so the port follows
    the registration of whichever torch it runs on."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg as fake_pg
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "a real process group is initialised; the dry-run mesh "
                "needs a fake one of its own (run it in another process)")
        if dist.get_world_size() == world_size and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=rank,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda",
                         rank: int = 0):
    """The production mesh as a dry-run ``DeviceMesh`` on a fake group of
    256 (16 x 16) or 512 (2 x 16 x 16) ranks; this process is ``rank``."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    return make_fake_mesh(shape, names, device=device, rank=rank)


def make_fake_mesh(shape, names, device: str = "cuda", rank: int = 0):
    """A dry-run ``DeviceMesh`` of any shape on a fake group of as many
    ranks (the production mesh's, or the tests' small ones)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    fake_group(n, rank)
    return init_device_mesh(str(device).split(":")[0], tuple(shape),
                            mesh_dim_names=tuple(names))


def mesh_axes(*, multi_pod: bool = False) -> MeshAxes:
    return MeshAxes(pod="pod" if multi_pod else None)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, device: str = "cpu"):
    """A (n_data, n_model) ("data", "model") mesh on the initialised
    process group (real ranks: the tests' gloo processes)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


# NVIDIA H100 SXM5 80GB (datasheet, 700 W): roofline targets per card
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                # HBM3 bytes/s
NVLINK_BW = 450e9               # NVLink 4 bytes/s a direction
