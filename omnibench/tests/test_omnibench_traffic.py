"""The traffic generator: fixed by the seed, within its length ranges, the
same work for every seed."""
import numpy as np
import pytest

from omnibench import spec
from omnibench.traffic import Traffic, gap_pool, length_pool

MIXES = ["lmsys_poisson", "lmsys_backlog32", "alpaca_backlog16"]


def _mix(name):
    return spec.read_json(spec.HERE / "traffic" / f"{name}.json")


def _first(tr, n):
    if tr.loop == "open":
        it = tr.arrivals()
        return [next(it) for _ in range(n)]
    return [next(tr.client(c)) for c in range(int(tr.spec["clients"]))]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    a = _first(Traffic(_mix(mix), 92544, 2**31 + 77, 51), 40)
    b = _first(Traffic(_mix(mix), 92544, 2**31 + 77, 51), 40)
    c = _first(Traffic(_mix(mix), 92544, 2**31 + 78, 51), 40)
    assert all(x.due == y.due and x.out_len == y.out_len and np.array_equal(x.tokens, y.tokens)
               for x, y in zip(a, b))
    assert any(not np.array_equal(x.tokens[:4], y.tokens[:4]) for x, y in zip(a, c))


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_in_range(mix):
    m = _mix(mix)
    for it in _first(Traffic(m, 92544, 5, 51), 200):
        assert m["prompt"]["min"] <= len(it.tokens) <= m["prompt"]["max"]
        assert m["output"]["min"] <= it.out_len <= m["output"]["max"]
        assert it.tokens.min() >= 0 and it.tokens.max() < 92544


def test_open_loop_replays_one_schedule_for_every_seed():
    m = _mix("lmsys_poisson")
    a = _first(Traffic(m, 92544, 3, 51), 60)
    b = _first(Traffic(m, 92544, 2**31 + 99, 51), 60)
    assert [(x.due, len(x.tokens), x.out_len) for x in a] == [
        (y.due, len(y.tokens), y.out_len) for y in b]
    other = _first(Traffic(dict(m, schedule_seed=2), 92544, 3, 51), 60)
    assert [x.out_len for x in a] != [x.out_len for x in other]


def test_open_loop_window_is_the_same_work_for_every_seed():
    m = _mix("lmsys_poisson")
    seconds = 51.0
    per_seed = []
    for seed in (1, 2**31 + 5, 123456789):
        tr = Traffic(m, 92544, seed, seconds)
        items = []
        for it in tr.arrivals():
            if it.cycle > 1:
                break
            if it.cycle == 1:
                items.append(it)
        assert len(items) == tr.window_count == round(m["rate_per_s"] * seconds)
        dues = [it.due for it in items]
        assert dues == sorted(dues) and dues[0] == 0.0 and dues[-1] < seconds
        per_seed.append((sorted(len(it.tokens) for it in items),
                         sorted(it.out_len for it in items)))
    assert all(p == per_seed[0] for p in per_seed)


def test_pre_roll_precedes_the_window():
    m = _mix("lmsys_poisson")
    tr = Traffic(m, 1000, 9, 20)
    pre = []
    for it in tr.arrivals():
        if it.cycle != 0:
            break
        pre.append(it.due)
    assert pre and -m["pre_s"] <= min(pre) and max(pre) < 0


def test_closed_loop_rounds_deal_the_same_pool():
    m = _mix("alpaca_backlog16")
    n = m["clients"]
    tr = Traffic(m, 151936, 31, 51)
    streams = [tr.client(c) for c in range(n)]
    pool = sorted(length_pool(m["output"], n).tolist())
    for _ in range(3):
        assert sorted(next(s).out_len for s in streams) == pool


def test_pools():
    g = gap_pool(1.5, 76, 51.0)
    assert g.sum() == pytest.approx(51.0) and (g > 0).all()
    lp = length_pool({"dist": "lognormal", "mean": 300, "sigma": 0.7, "min": 64,
                      "max": 1024}, 101)
    assert abs(lp.mean() - 300) <= 1.0 and lp.min() >= 64 and lp.max() <= 1024
    up = length_pool({"dist": "uniform", "min": 32, "max": 96}, 8)
    assert up.tolist() == sorted(up.tolist()) and up.min() >= 32 and up.max() <= 96


@pytest.mark.parametrize("mix", MIXES)
def test_pools_keep_the_published_means(mix):
    m = _mix(mix)
    if m["loop"] == "open":
        n = Traffic(m, 92544, 1, spec.load_benchmark()["run_seconds"]).window_count
    else:
        n = int(m["clients"])
    for part in ("prompt", "output"):
        if "mean" in m[part]:
            pool = length_pool(m[part], n)
            assert abs(pool.mean() - m[part]["mean"]) <= 1.0, (part, pool.mean())


def test_a_fitted_pool_has_the_mean_at_every_size():
    d = {"dist": "lognormal", "mean": 214.5, "sigma": 0.7, "min": 8, "max": 512}
    for n in (8, 16, 51, 200):
        pool = length_pool(d, n)
        assert abs(pool.mean() - 214.5) <= 1.0 and pool.min() >= 8 and pool.max() <= 512
        assert pool.tolist() == sorted(pool.tolist())
