"""The port's copy of the page allocator against repro.core.pages: one
seeded random sequence of admit / ensure / shrink / release drives both,
and tables, free counts, results and stats are equal after every step;
the copy's invariants hold throughout."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import pages as jpages  # noqa: E402
from repro_torch.core import pages as tpages  # noqa: E402


@pytest.mark.parametrize("seed", range(4))
def test_allocator_matches_reference_step_for_step(seed):
    rng = np.random.default_rng(seed)
    n_slots, ps = int(rng.integers(2, 6)), int(rng.choice([4, 8, 16]))
    maxp = int(rng.integers(2, 9))
    n_pages = int(rng.integers(maxp, n_slots * maxp + 1))
    ref = jpages.PageAllocator(n_pages, ps, n_slots, maxp)
    got = tpages.PageAllocator(n_pages, ps, n_slots, maxp)
    cap = maxp * ps
    for _ in range(300):
        slot = int(rng.integers(0, n_slots))
        op = rng.choice(["admit", "ensure", "shrink", "release"])
        n = int(rng.integers(0, cap + 1))
        if op == "admit":
            if ref.slot_pages(slot):
                ref.release(slot)
                got.release(slot)
            res = (ref.admit(slot, n), got.admit(slot, n))
        elif op == "ensure":
            res = (ref.ensure(slot, n), got.ensure(slot, n))
        elif op == "shrink":
            res = (ref.shrink(slot, n), got.shrink(slot, n))
        else:
            res = (ref.release(slot), got.release(slot))
        assert res[0] == res[1], op
        np.testing.assert_array_equal(ref.table, got.table)
        assert (ref.free_pages, ref.pages_in_use) == \
            (got.free_pages, got.pages_in_use)
        assert ref.stats().__dict__ == got.stats().__dict__
        assert ref.slot_tokens_capacity(slot) == \
            got.slot_tokens_capacity(slot)
        got.check()
    assert tpages.pages_for(0, ps) == 0
    assert tpages.pages_for(ps + 1, ps) == jpages.pages_for(ps + 1, ps) == 2
