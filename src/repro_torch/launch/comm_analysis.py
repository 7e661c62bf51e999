"""Per-device cost and collective accounting of a DTensor program (the
port's counterpart of ``repro.launch.hlo_analysis``).

The reference compiles a step with XLA and parses the HLO text for its
collectives, multiplying the layer scan's body by its trip count.  The
port has no HLO, so the module is named for what it reads instead: the
collectives themselves, as they are dispatched.  DTensor lowers every
redistribution, and ``local_map`` code every explicit collective, to the
c10d functional ops (``_c10d_functional.all_reduce``,
``all_gather_into_tensor``, ...), which reach a ``TorchDispatchMode`` on
each rank's local tensors.  The layers and the SSM mixers' position
loops are Python loops, so every trip is dispatched; a calibrated count
(``launch.dryrun.calibrated_counts``) dispatches two trips of a position
loop (four with gradients) and multiplies, and traces two layer counts and
extrapolates, as the reference's ``--calibrate`` does for XLA's scans.

``DeviceCostMode`` sees one rank's program: it lets DTensor desugar each
of its ops (returning ``NotImplemented`` for DTensor arguments, as
``CommDebugMode`` does) and then reads the local ops:

  flops            ``FlopCounterMode``'s formulas (its registry, and its
                   decomposition of ops outside it) on each local op, so
                   a sharded matmul counts the rank's share only;
  bytes accessed   the operand and result bytes of every local aten op
                   that is not a view or a collective;
  peak bytes       the most bytes of storage that the local ops made
                   and that were alive at once (the way MemTracker
                   counts: each new storage once, freed when its last
                   tensor dies; rounded up to the CUDA caching
                   allocator's 512 B blocks on a card), arguments that
                   existed before the step not included;
  collectives      each functional collective's kind, under the
                   reference's names (all-reduce, all-gather,
                   reduce-scatter, all-to-all, collective-permute), and
                   its result bytes, summed as ``hlo_analysis._shape_bytes``
                   sums result shapes; and every all-gather's result
                   shape (``gathered``).

On a fake process group the collectives move nothing and return
uninitialised data; their kinds and sizes are the real program's.  A
CPU group has no all-to-all, so DTensor falls back to all-gather there
(the card's group issues the all-to-all).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional",
               "_c10d_functional_autograd", "_dtensor")


def collective_kind(func):
    """The reference's name of a functional collective op, or None."""
    packet = func._overloadpacket
    if packet.__module__.split(".")[-1] not in _NAMESPACES and \
            getattr(func, "namespace", None) not in _NAMESPACES:
        return None
    return _KINDS.get(packet.__name__)


def storage_bytes(t) -> int:
    """The bytes ``DeviceCostMode`` counts for a new storage like t's: its
    size, rounded up to the CUDA caching allocator's 512 B blocks on a
    card."""
    n = t.untyped_storage().nbytes()
    return -(-n // 512) * 512 if t.device.type == "cuda" else n


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def _bytes(tree) -> int:
    return sum(_tensor_bytes(t) for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class _BackwardTrip:
    """``DeviceCostMode.repeat_backward``: hooks on two states a position
    loop hands on, mark at the later one's gradient, add (and drop the
    stand-in) at the earlier one's."""

    def __init__(self, mode, times):
        self.mode, self.times, self.mark, self.kept = mode, times, None, None

    def keep(self, nbytes: int):
        """The stand-in, from now on.  Under a checkpoint the forward saves
        nothing (``nbytes`` 0), and the recompute, inside the backward,
        leaves its stand-in to the forward's loop, whose hooks fire."""
        if nbytes <= 0:
            return
        with self.mode.uncounted():
            lump = torch.empty(nbytes, dtype=torch.uint8)
        if torch._C._current_graph_task_id() != -1:
            self.mode._recomputed = lump
        else:
            self.kept = lump

    @staticmethod
    def _when_all(tree, fire):
        from torch.utils._pytree import tree_flatten
        ts = [t for t in tree_flatten(tree)[0] if t.requires_grad]
        left = [len(ts)]

        def hook(g):
            left[0] -= 1
            if left[0] == 0:
                fire()
        for t in ts:
            t.register_hook(hook)

    def starts_at(self, state):
        def fire():
            self.mark = self.mode.counts()
            if self.kept is None:
                self.kept, self.mode._recomputed = \
                    self.mode._recomputed, None
        self._when_all(state, fire)

    def ends_at(self, state):
        def fire():
            self.mode.add(self.mode.since(self.mark), self.times)
            self.kept = None
        self._when_all(state, fire)


@dataclasses.dataclass
class CollectiveStats:
    per_kind_bytes: dict
    per_kind_count: dict
    total_bytes: float


class DeviceCostMode(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes accessed and collectives (see the
    module docstring).  Use as a context manager around the step."""

    supports_higher_order_operators = True

    def __init__(self, time_limit: float = None):
        """``time_limit``: seconds after which the next compute op outside
        a backward pass raises ``TimeoutError`` (a sweep's cap on one
        step's trace)."""
        super().__init__()
        self.deadline = None if time_limit is None else \
            time.monotonic() + time_limit
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode().flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.live = self.peak = 0
        self._seen = weakref.WeakSet()
        self._waited = weakref.WeakKeyDictionary()
        self.coll_bytes = defaultdict(int)
        self.coll_count = defaultdict(int)
        self.gathered = []          # every all-gather's result shape
        self._shape_only = 0
        self._uncounted = 0
        self._recomputed = None     # a recomputed loop's stand-in
        self._unpatch = []          # re-entered to decompose ops: a stack

    def __enter__(self):
        # DTensor finds an op's output shapes by running it once on fake
        # tensors (the first time it sees the op's schema); those runs are
        # not the rank's work, and counting them would make the count
        # depend on DTensor's cache
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        orig = SP._propagate_tensor_meta_non_cached
        mode = self

        def shape_only(prop, op_schema):
            mode._shape_only += 1
            try:
                return orig(prop, op_schema)
            finally:
                mode._shape_only -= 1

        SP._propagate_tensor_meta_non_cached = shape_only
        self._unpatch.append(lambda: setattr(
            SP, "_propagate_tensor_meta_non_cached", orig))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch.pop()()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._shape_only:
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if self._uncounted and not any(issubclass(t, DTensor)
                                       for t in types):
            out = func(*args, **kwargs)
            self._track(out, (args, kwargs))
            return out
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor desugar it first
        if func is torch.ops._c10d_functional.wait_tensor.default:
            # a card's wait returns its input; a fake tensor's, a new
            # storage for the same data: counted as the input, alive while
            # either is
            out = func(*args, **kwargs)
            st = out.untyped_storage()
            if st is not args[0].untyped_storage():
                self._seen.add(st)
                self._waited[st] = args[0]
            return out
        kind = collective_kind(func)
        if kind is not None:
            out = func(*args, **kwargs)
            self.coll_bytes[kind] += _bytes(out)
            self.coll_count[kind] += 1
            if kind == "all-gather":
                self.gathered.append(tuple(out.shape))
            self._track(out, (args, kwargs))
            return out
        if func not in self.registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self.registry:
            if func._overloadname == "dtype":
                # mm / bmm with an output dtype: the formula's third
                # parameter is out_shape, not the dtype
                self.flops += self.registry[packet](*args[:2], out_val=out)
            else:
                self.flops += self.registry[packet](*args, **kwargs,
                                                    out_val=out)
        if not func.is_view and func.namespace == "aten":
            self.bytes_accessed += _bytes((args, kwargs)) + _bytes(out)
            # checked after a compute op outside a backward pass only: an
            # exception from a metadata query (prim.device) or from the
            # autograd engine's thread aborts the process
            if self.deadline is not None and \
                    time.monotonic() > self.deadline and \
                    torch._C._current_graph_task_id() == -1:
                raise TimeoutError("the step's trace ran past its time "
                                   "limit")
        self._track(out, (args, kwargs))
        return out

    def _track(self, out, inputs=()):
        # an input's storage is not new (it may predate the step: a view
        # of it allocates nothing)
        for t in tree_flatten(inputs)[0]:
            if isinstance(t, torch.Tensor):
                self._seen.add(t.untyped_storage())
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = storage_bytes(t)
            self._seen.add(st)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n):
        self.live -= n

    @staticmethod
    def storage_of(tensors) -> int:
        """The bytes the mode counts for new storages of ``tensors``."""
        return sum(map(storage_bytes, tensors))

    def counts(self) -> dict:
        """The counters so far: FLOPs, bytes accessed, and collective
        bytes and counts by kind."""
        return {"flops": self.flops, "bytes accessed": self.bytes_accessed,
                "coll_bytes": dict(self.coll_bytes),
                "coll_count": dict(self.coll_count)}

    def since(self, mark: dict) -> dict:
        """The counts added since ``mark`` (a ``counts()``)."""
        now = self.counts()
        delta = {k: now[k] - mark[k] for k in ("flops", "bytes accessed")}
        for key in ("coll_bytes", "coll_count"):
            delta[key] = {kind: v - mark[key].get(kind, 0)
                          for kind, v in now[key].items()}
        return delta

    def add(self, delta: dict, times: int):
        """``delta`` (a ``since``) counted ``times`` more."""
        self.flops += delta["flops"] * times
        self.bytes_accessed += delta["bytes accessed"] * times
        for key, tgt in (("coll_bytes", self.coll_bytes),
                         ("coll_count", self.coll_count)):
            for kind, v in delta[key].items():
                tgt[kind] += v * times

    @contextlib.contextmanager
    def uncounted(self):
        """Ops that run without being counted; their new storages are
        live storage all the same."""
        self._uncounted += 1
        try:
            yield
        finally:
            self._uncounted -= 1

    def stand_in(self, tree):
        """Uncounted empty tensors of ``tree``'s shapes (a position
        loop's final state after trips not dispatched)."""
        from torch.utils._pytree import tree_map
        with self.uncounted():
            return tree_map(torch.empty_like, tree)

    def stand_in_trips(self, leaves, times: int):
        """``times`` trips' outputs of the shapes of ``leaves``, each a
        view of one uncounted buffer a leaf: [[leaf views] a trip]."""
        with self.uncounted():
            views = [x.new_empty((times,) + tuple(x.shape)).unbind(0)
                     for x in leaves]
        return [list(v) for v in zip(*views)]

    def repeat_backward(self, times: int):
        """Counts one trip's backward ``times`` more: from when every
        tensor of the state a trip hands on (``starts_at``) has its
        gradient to when every tensor of the state it took (``ends_at``)
        has its own, through tensor hooks.  Until then an uncounted
        stand-in (``keep``: the bytes the trips not dispatched save for
        the backward) is live storage, as those tensors are in the whole
        trace from the loop's forward (or a checkpoint's recompute) until
        its backward has passed the last of those trips."""
        return _BackwardTrip(self, times)

    def stats(self) -> CollectiveStats:
        per = dict(self.coll_bytes)
        return CollectiveStats(per, dict(self.coll_count),
                               float(sum(per.values())))


def collective_summary(mode: DeviceCostMode) -> dict:
    """The reference's record keys for one rank's collectives."""
    st = mode.stats()
    return {"total_collective_bytes": st.total_bytes,
            "per_kind_bytes": st.per_kind_bytes,
            "per_kind_count": st.per_kind_count}
