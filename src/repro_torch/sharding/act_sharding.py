"""Activation-sharding hooks (mirrors ``repro.sharding.act_sharding``):
set by the dry run, inert without a mesh.

``constrain`` is the port's ``with_sharding_constraint``: it
redistributes a DTensor to the placements of a divisibility-guarded spec
(DTensor issues the all-gather, reduce-scatter or all-to-all that takes
it there); a plain tensor, or any tensor while no mesh is set, passes
through unchanged.

Sequence-parallel residuals: between layers of the train path the
carried activation (B, S, d) is sharded over both the data (batch) and
the model (sequence) axes, Megatron-SP style; the layer's first
projection gathers it back.
"""
MESH = None
AXES = None
SEQ_PARALLEL_RESIDUALS = False


def set_mesh(mesh, axes, seq_parallel: bool = False):
    global MESH, AXES, SEQ_PARALLEL_RESIDUALS
    MESH, AXES, SEQ_PARALLEL_RESIDUALS = mesh, axes, seq_parallel


def constrain(x, *spec):
    """Redistribute the DTensor ``x`` to ``spec``'s placements, each axis
    kept only where it divides its dim; a no-op without a mesh or on a
    plain tensor."""
    if MESH is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.partition import (_size, mesh_sizes,
                                                to_placements)
    sizes = mesh_sizes(MESH)
    fixed = tuple(ax if ax is None or dim % _size(sizes, ax) == 0 else None
                  for dim, ax in zip(x.shape, spec))
    placements = to_placements(fixed, MESH)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(MESH, placements)


def residual_constraint(x):
    """The residual stream's sharding between layers (train only)."""
    if MESH is None or AXES is None:
        return x
    if SEQ_PARALLEL_RESIDUALS:
        return constrain(x, AXES.dp, AXES.model, None)
    return constrain(x, AXES.dp, None, None)
