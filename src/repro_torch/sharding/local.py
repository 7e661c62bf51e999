"""What the port's model code needs to run on DTensor parameters (the
dry run, ``launch.dryrun``): the steps that DTensor has no sharding
strategy for, or would meet by gathering a whole tensor, run on each
rank's local shards through ``local_map`` with placements derived from
their operands (cache writes, attention cores, the vocab-parallel
embedding, cross entropy, pick and argmax), and the few redistributions the
model code asks for by name (``settled`` partial sums, gradients
``laid_out_as`` their parameters).  Every helper is the plain operation
on plain tensors, and nothing here imports ``torch.distributed`` unless a
DTensor is already in play: plain tensors pay one dictionary lookup."""
from __future__ import annotations

import contextlib
import sys

import torch


def is_dtensor(t) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _shard_dims(placements, dim):
    return [i for i, p in enumerate(placements)
            if p.is_shard() and p.dim == dim]


def shard_offset(mesh, placements, dim: int, local_n: int) -> int:
    """The global index of this rank's first element on tensor dim
    ``dim`` (mesh dims sharding one tensor dim nest left to right)."""
    idx = 0
    for m in _shard_dims(placements, dim):
        idx = idx * mesh.size(m) + mesh.get_local_rank(m)
    return idx * local_n


def _moved(placements, moves):
    """placements with each Shard(d) moved to Shard(moves[d]) (Replicate
    where moves[d] is None)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in placements:
        if p.is_shard():
            d = moves.get(p.dim, p.dim)
            out.append(Replicate() if d is None else Shard(d))
        else:
            out.append(p)
    return out


def write_rows(cache, idx, vals):
    """``cache[b, idx[b, l]] = vals[b, l]`` for every batch row b, IN PLACE:
    cache (B, Sc, ...), idx (B, L), vals (B, L, ...).  On a DTensor cache
    each rank writes its local shard: its own batch rows, and where the
    cache's sequence is sharded (context parallelism), only positions of
    its own block (one position a row, L = 1: the decode step)."""
    if not is_dtensor(cache):
        B = cache.shape[0]
        bidx = torch.arange(B, device=cache.device)[:, None]
        cache[bidx, idx] = vals.to(cache.dtype)
        return cache
    from torch.distributed.tensor.experimental import local_map
    mesh, cpl = cache.device_mesh, list(cache.placements)
    seq_sharded = bool(_shard_dims(cpl, 1))
    if seq_sharded and idx.shape[1] != 1:
        raise NotImplementedError("a sequence-sharded cache takes one new "
                                  "position a row")
    idx_pl = _moved(cpl, {d: None for d in range(1, cache.ndim)})
    val_pl = _moved(cpl, {1: None})

    def local(c, i, v):
        bidx = torch.arange(c.shape[0], device=c.device)[:, None]
        if seq_sharded:
            n = c.shape[1]
            i = i - shard_offset(mesh, cpl, 1, n)
            mine = (i >= 0) & (i < n)
            i = i.clamp(0, n - 1)
            keep = mine.reshape(mine.shape + (1,) * (v.ndim - 2))
            v = torch.where(keep, v.to(c.dtype), c[bidx, i])
        c[bidx, i] = v.to(c.dtype)
        return c

    local_map(local, out_placements=cpl, in_placements=(cpl, idx_pl, val_pl),
              device_mesh=mesh, redistribute_inputs=True)(cache, idx, vals)
    return cache


def as_dtensor(t, mesh):
    """A plain tensor as a DTensor replicated over ``mesh`` (None stays
    None, a DTensor stays as it is)."""
    if t is None or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class ContextShards:
    """What a rank of a sequence-sharded (context-parallel) cache needs in
    an attention core: the global index of its first slot, the cache's
    global length, and ``reduce(t, op)`` over the ranks that share the
    sequence ("max" or "sum")."""

    def __init__(self, mesh, dims, offset: int, total: int):
        self.mesh, self.dims, self.offset, self.total = mesh, dims, offset, \
            total

    def reduce(self, t, op: str):
        from torch.distributed import _functional_collectives as funcol
        for m in self.dims:
            t = funcol.all_reduce(t, op, (self.mesh, m))
        return t


def heads_local(fn, q, kv, rows=(), context_parallel: bool = False):
    """``fn(q, *kv, *rows[, cp])`` on each rank's local shards: q (B, S,
    nq, ·), kv caches or keys/values (B, Sk, nkv, ·) or (B, Sk, ·) (one
    latent head), rows (B, ·) position and mask tensors (None allowed).
    The batch is sharded over the data axes where it divides, the query
    heads over ``model`` where they divide and the KV heads with them
    (a rank whose query heads share KV heads it does not hold takes its
    slice of the replicated ones).  With ``context_parallel`` a cache
    sequence-sharded over the data axes (batch 1) stays so, and ``fn``
    gets a ``ContextShards`` as its last argument (None otherwise).
    Returns fn's (B, S, nq, ·) output, laid out as q."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t for t in (q, *kv) if is_dtensor(t)).device_mesh
    names = list(mesh.mesh_dim_names)
    mi = names.index("model")
    M = mesh.size(mi)
    dp = [i for i in range(mesh.ndim) if i != mi]
    D = 1
    for i in dp:
        D *= mesh.size(i)
    B, nq = q.shape[0], q.shape[2]
    b_sh = B % D == 0
    q_sh = nq % M == 0
    kv0 = kv[0]
    cp = context_parallel and not b_sh and is_dtensor(kv0) and \
        bool(_shard_dims(kv0.placements, 1))
    kv_sh = q_sh and kv0.ndim == 4 and kv0.shape[2] % M == 0

    def pl(batch, model, seq=False):
        out = []
        for i in range(mesh.ndim):
            if i == mi:
                out.append(model)
            elif seq:
                out.append(Shard(1))
            else:
                out.append(Shard(0) if b_sh and batch else Replicate())
        return out

    q_pl = pl(True, Shard(2) if q_sh else Replicate())
    kv_pl = [pl(True, Shard(2) if kv_sh and t.ndim == 4 else Replicate(),
                seq=cp) for t in kv]
    rows = [as_dtensor(r, mesh) for r in rows]
    row_pl = [None if r is None else pl(True, Replicate()) for r in rows]
    q, kv = as_dtensor(q, mesh), [as_dtensor(t, mesh) for t in kv]
    n_kv = len(kv)

    def local(ql, *args):
        ql = contiguous_grad(ql)
        kvl = [contiguous_grad(t) for t in args[:n_kv]]
        rl = list(args[n_kv:])
        if q_sh and not kv_sh and kvl[0].ndim == 4:
            nql, qpk = ql.shape[2], nq // kvl[0].shape[2]
            if nql % qpk and qpk % nql:
                raise NotImplementedError(
                    f"{nql} query heads a rank straddle KV groups of {qpk}")
            lo = mesh.get_local_rank(mi) * nql // qpk
            n = max(nql // qpk, 1)
            kvl = [t[:, :, lo:lo + n] if t.ndim == 4 else t for t in kvl]
        ctx = None
        if cp:
            n = kvl[0].shape[1]
            ctx = ContextShards(mesh, dp, shard_offset(
                mesh, kv0.placements, 1, n), kv0.shape[1])
        return fn(ql, *kvl, *rl, ctx)

    # a rank that uses a slice of replicated KV heads holds a partial
    # gradient of them over ``model``
    kv_grad = [[Partial() if i == mi and q_sh and not kv_sh else p
                for i, p in enumerate(pl_)] for pl_ in kv_pl]
    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, *kv_pl, *row_pl),
                     in_grad_placements=(q_pl, *kv_grad, *row_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
                         q, *kv, *rows)


def argmax_last(x):
    """``x.argmax(-1)``; on a DTensor sharded on its last dim (the
    vocabulary over ``model``) each rank takes its block's maximum, and
    the (value, index) pairs of the ranks, one a row, are gathered and
    the first maximum kept (ties go to the lowest index, as in torch and
    jnp), so the logits themselves never leave their rank."""
    if not is_dtensor(x):
        return x.argmax(-1)
    last = x.ndim - 1
    dims = _shard_dims(x.placements, last)
    if not dims:
        return x.argmax(-1)
    if len(dims) > 1:
        raise NotImplementedError("last dim sharded over several mesh dims")
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, m, xpl = x.device_mesh, dims[0], list(x.placements)
    out_pl = [Replicate() if i == m else p for i, p in enumerate(xpl)]

    def local(xl):
        val, idx = xl.max(-1)
        idx = idx + shard_offset(mesh, xpl, last, xl.shape[-1])
        vals = funcol.all_gather_tensor(val[None], 0, (mesh, m))
        idxs = funcol.all_gather_tensor(idx[None], 0, (mesh, m))
        return idxs.gather(0, vals.argmax(0, keepdim=True))[0]

    return local_map(local, out_placements=out_pl, in_placements=(xpl,),
                     device_mesh=mesh)(x)


def part_blocks(u, n_parts: int, mesh, mdim: int):
    """u: one rank's block (..., n_parts * n) of a tensor (..., n_parts *
    N) sharded on its last dim over mesh dim ``mdim`` (M ranks, N = M n),
    whose last dim is ``n_parts`` concatenated parts of N channels (a
    fused projection: Mamba's [x | z], sLSTM's [i | f | z | o]).  Returns
    (..., n_parts, n): every part's channels of this rank's own block
    [rank n, rank n + n), by one all-to-all over ``mdim`` (differentiable:
    the backward is the reverse all-to-all)."""
    from torch.distributed import _functional_collectives as funcol
    M, r = mesh.size(mdim), mesh.get_local_rank(mdim)
    n = u.shape[-1] // n_parts
    # global block k (n channels) is part k // M, channel block k % M, and
    # this rank holds blocks n_parts r .. n_parts r + n_parts - 1; the
    # all-to-all sends in order of destination and receives in order of
    # source, which is the parts' order
    ks = sorted(range(n_parts * r, n_parts * (r + 1)), key=lambda k: k % M)
    send, recv = [0] * M, [0] * M
    for k in ks:
        send[k % M] += n
    for p in range(n_parts):
        recv[(p * M + r) // n_parts] += n
    blocks = u.unflatten(-1, (n_parts, n))
    lead = tuple(u.shape[:-1])
    t = torch.stack([blocks[..., k - n_parts * r, :] for k in ks], 0)
    out = funcol.all_to_all_single_autograd(
        t.movedim(-1, 1).reshape((n_parts * n,) + lead), recv, send,
        (mesh, mdim))
    # a copy, not a view: a view of the collective's result stays an
    # ``AsyncCollectiveTensor``, which ``local_map`` unwraps without its
    # autograd history when it next takes the tensor in
    return out.reshape((n_parts, n) + lead).movedim(0, -1).movedim(0, -1) \
        .contiguous()


def laid_out_as(t, ref):
    """``t`` redistributed to ``ref``'s placements when both are DTensors
    (a gradient left partial over the data axes is summed there: the data
    parallel all-reduce, or a reduce-scatter for a sharded parameter)."""
    if not is_dtensor(t) or tuple(t.placements) == tuple(ref.placements):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def replicated(t):
    """A DTensor (a scalar: a norm, a loss) summed or gathered to
    ``Replicate()`` on every mesh dim; a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(x):
    """x itself, whose gradient is made contiguous on its way back out of
    a ``local_map`` (DTensor's backward views the local gradient, which
    fails on a strided one)."""
    return _ContiguousGrad.apply(x) if x.requires_grad else x


def local_of(t):
    """A DTensor's local shard (the tensor itself, aliased: in-place ops
    on it update the DTensor); a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def embedding_rows(table, tokens, dtype):
    """``table[tokens].to(dtype)`` for a DTensor table (V, d): each rank
    looks the tokens up in its block of the vocabulary (zeros for the
    others), and the partial rows are summed over the ranks that split
    the vocabulary, once (Megatron's vocab-parallel embedding); the rows
    come out laid out as ``tokens``.  A table sharded on d (FSDP) is
    gathered over those axes first; its gradient is partial over the data
    axes that split the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tokens = as_dtensor(tokens, mesh)
    tok_pl = list(tokens.placements)
    vdims = _shard_dims(table.placements, 0)
    tab_pl = [Shard(0) if i in vdims else Replicate()
              for i in range(mesh.ndim)]
    grad_pl = [Shard(0) if i in vdims else
               (Partial() if tok_pl[i].is_shard() else Replicate())
               for i in range(mesh.ndim)]
    out_pl = [Partial() if i in vdims else tok_pl[i]
              for i in range(mesh.ndim)]

    def local(tl, tk):
        n = tl.shape[0]
        idx = tk - shard_offset(mesh, tab_pl, 0, n)
        rows = tl[idx.clamp(0, n - 1)].to(dtype)
        if vdims:
            ok = (idx >= 0) & (idx < n)
            rows = rows * ok[..., None].to(dtype)
        return rows

    x = local_map(local, out_placements=out_pl,
                  in_placements=(tab_pl, tok_pl),
                  in_grad_placements=(grad_pl, tok_pl), device_mesh=mesh,
                  redistribute_inputs=True)(table, tokens)
    return x.redistribute(mesh, tok_pl)


def settled(t):
    """A DTensor left partial by a row-parallel product (the attention
    output, the FFN down-projection, the MoE's experts) summed where the
    residual stream takes it: one all-reduce, so what follows (a norm,
    the next layer's column-parallel projections) reads whole rows.  A
    plain tensor as it is."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


class _VocabParallelNLL(torch.autograd.Function):
    """-log_softmax(z)[label] of one rank's block z (..., n) of the
    vocabulary: the max, then the sum of exponentials and the label's
    logit (the block that holds it gives it, the others 0), all-reduced
    by ``reduce(t, op)`` over the ranks that split the vocabulary.  The
    backward is local: softmax_block - onehot_block, times the upstream
    gradient, which is whole on every rank (the loss is)."""

    @staticmethod
    def forward(ctx, z, j, reduce):
        n = z.shape[-1]
        mine = (j >= 0) & (j < n)
        jc = j.clamp(0, n - 1)
        m = reduce(z.amax(-1), "max")
        picked = z.gather(-1, jc[..., None])[..., 0] * mine.to(z.dtype)
        s = reduce(torch.stack([torch.exp(z - m[..., None]).sum(-1),
                                picked]), "sum")
        lse = m + s[0].log()
        ctx.save_for_backward(z, jc, mine, lse)
        return lse - s[1]

    @staticmethod
    def backward(ctx, g):
        z, jc, mine, lse = ctx.saved_tensors
        grad = torch.exp(z - lse[..., None]).mul_(g[..., None])
        grad.scatter_add_(-1, jc[..., None],
                          -(g * mine.to(g.dtype))[..., None])
        return grad, None, None


def nll_last(x, idx):
    """``-torch.log_softmax(x, -1)`` at ``idx`` (x (..., V), idx (...)):
    the cross entropy's per-row loss.  On a DTensor sharded on its last
    dim (the vocabulary over ``model``) each rank computes it on its own
    block in one ``local_map`` (Megatron's vocab-parallel cross
    entropy): two all-reduces of (...) rows forward, none backward, and
    the logits' gradient leaves laid out as the logits, so neither x nor
    its gradient is ever gathered.  Otherwise (a plain tensor, or a
    replicated vocabulary) ``torch.log_softmax`` and ``take_last``."""
    if not is_dtensor(x) or not _shard_dims(x.placements, x.ndim - 1):
        return -take_last(torch.log_softmax(x, dim=-1), idx)
    last = x.ndim - 1
    dims = _shard_dims(x.placements, last)
    if len(dims) > 1:
        raise NotImplementedError("last dim sharded over several mesh dims")
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, xpl = x.device_mesh, list(x.placements)
    idx_pl = [p if p.is_shard() and p.dim < last else Replicate()
              for p in xpl]

    def reduce(t, op):
        return funcol.all_reduce(t, op, (mesh, dims[0]))

    def local(xl, il):
        j = il - shard_offset(mesh, xpl, last, xl.shape[-1])
        return _VocabParallelNLL.apply(xl, j, reduce)

    return local_map(local, out_placements=idx_pl,
                     in_placements=(xpl, idx_pl),
                     in_grad_placements=(xpl, idx_pl), device_mesh=mesh,
                     redistribute_inputs=True)(x, as_dtensor(idx, mesh))


def take_last(x, idx):
    """``x.gather(-1, idx[..., None])[..., 0]`` for x whose last dim is
    whole on every rank (a vocab-sharded x goes through ``nll_last``); on
    a DTensor each rank picks from its own rows, so neither x nor its
    gradient is ever gathered (DTensor's own gather backward builds a
    zero tensor of x's global shape)."""
    if not is_dtensor(x):
        return x.gather(-1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    last = x.ndim - 1
    if _shard_dims(x.placements, last):
        raise NotImplementedError("take_last of a last dim sharded over "
                                  "the mesh")
    xpl = list(x.placements)
    idx_pl = [p if p.is_shard() and p.dim < last else Replicate()
              for p in xpl]

    def local(xl, il):
        return xl.gather(-1, il[..., None])[..., 0]

    return local_map(local, out_placements=idx_pl,
                     in_placements=(xpl, idx_pl),
                     in_grad_placements=(xpl, idx_pl),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(
                         x, as_dtensor(idx, x.device_mesh))


@contextlib.contextmanager
def gathered_over_data(module, names=None):
    """FSDP's gather at use: inside the block, every DTensor parameter of
    ``module`` (its own ``names`` only, when given) that is sharded over a
    data axis reads as its all-gather over those axes, sharded over
    ``model`` as the rules say; the gradient flows back to the sharded
    parameter (a reduce-scatter).  Nothing changes for a module whose
    parameters are not sharded over the data axes."""
    from torch.distributed.tensor import Replicate
    swaps = []
    mods = [module] if names is not None else list(module.modules())
    for mod in mods:
        for name, prm in list(mod._parameters.items()):
            if prm is None or not is_dtensor(prm) or \
                    (names is not None and name not in names):
                continue
            dims = prm.device_mesh.mesh_dim_names
            new = [Replicate() if p.is_shard() and dims[i] != "model" else p
                   for i, p in enumerate(prm.placements)]
            if new != list(prm.placements):
                swaps.append((mod, name, prm))
                mod._parameters[name] = prm.redistribute(prm.device_mesh,
                                                         new)
    try:
        yield
    finally:
        for mod, name, prm in swaps:
            mod._parameters[name] = prm
