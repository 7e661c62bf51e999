"""The traffic generator: one length multiset for every seed, residual
first lengths spread over each device's drawn length."""
import json
import pathlib

import numpy as np
import pytest

from harness import traffic

TRAFFIC = pathlib.Path(__file__).resolve().parents[1] / "traffic"
FILES = sorted(p.stem for p in TRAFFIC.glob("*.json"))


def load(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", FILES)
def test_same_multiset_every_seed(name):
    t = load(name)
    seen = None
    for seed in (0, 1, 2 ** 31 + 12345, 987654321987):
        f = traffic.Fleet(t, 1000, seed)
        # after the first (residual) request, every device's list is the
        # file's multiset, in some order
        lists = sorted(tuple(sorted((len(r.prompt), r.out_len)
                                    for r in reqs[1:]))
                       for reqs in f.lists)
        if seen is None:
            seen = lists
        assert lists == seen
    base = traffic.multiset(t)
    p, o = zip(*base)
    assert min(p) == t["prompt_tokens"]["min"]
    assert max(p) == t["prompt_tokens"]["max"]
    assert min(o) == t["output_tokens"]["min"]
    assert max(o) == t["output_tokens"]["max"]
    assert len(set(p)) == t["multiset"]


@pytest.mark.parametrize("name", FILES)
def test_window_work_does_not_depend_on_seed(name):
    """The first requests of the fleet cover the same lengths for every
    seed: any run of consecutive entries of the fixed order is spread."""
    t = load(name)
    sums = []
    for seed in (3, 4, 5, 2 ** 31 + 7):
        f = traffic.Fleet(t, 1000, seed)
        sums.append(sum(len(r.prompt) for reqs in f.lists for r in reqs[1:4]))
    assert max(sums) == min(sums)


@pytest.mark.parametrize("name", FILES)
def test_first_requests_do_not_depend_on_seed(name):
    """The requests under way when the window opens: the same (prompt,
    residual output) pairs over the fleet for every seed."""
    t = load(name)
    firsts = {tuple(sorted((len(f.lists[d][0].prompt), f.lists[d][0].out_len)
                           for d in range(f.n)))
              for f in (traffic.Fleet(t, 1000, s)
                        for s in (0, 9, 2 ** 31 + 3, 987654321987))}
    assert len(firsts) == 1


def test_residual_first_lengths():
    n = 64
    got = sorted(traffic.residual(384, r, n) for r in range(n))
    assert got[0] >= 1 and got[-1] <= 384
    assert len(set(got)) == n                       # spread, no wave
    assert traffic.residual(1, 0, n) == 1
    gaps = np.diff(got)
    assert gaps.max() - gaps.min() <= 1


def test_seed_changes_tokens_not_lengths():
    t = load(FILES[0])
    a, b = traffic.Fleet(t, 1000, 1), traffic.Fleet(t, 1000, 2)
    assert any(not np.array_equal(x.prompt, y.prompt)
               for x, y in zip(a.lists[0], b.lists[0]))
    c = traffic.Fleet(t, 1000, 1)
    assert all(np.array_equal(x.prompt, y.prompt) and x.seed == y.seed
               for x, y in zip(a.lists[5], c.lists[5]))


def test_spread_order():
    assert traffic.spread_order(8) == [0, 4, 2, 6, 1, 5, 3, 7]
    assert sorted(traffic.spread_order(13)) == list(range(13))
