"""The traffic generator: a seed gives the same requests and arrivals; every
block of requests holds the same sizes; open-loop gaps are independent
exponential draws, so arrival counts vary as independent users' do."""
import itertools
import statistics

from perfbench.harness import registry
from perfbench.harness import traffic as gen

SEED = 2 ** 31 + 777


def test_a_seed_gives_the_same_requests_and_gaps():
    t = registry.traffic("dpmpp5-open")
    a = list(itertools.islice(gen.specs(t, SEED), 50))
    assert a == list(itertools.islice(gen.specs(t, SEED), 50))
    assert a != list(itertools.islice(gen.specs(t, SEED + 1), 50))
    assert list(itertools.islice(gen.gaps(t, SEED), 50)) == \
        list(itertools.islice(gen.gaps(t, SEED), 50))


def test_every_block_holds_the_same_sizes():
    t = registry.traffic("ddpm1000-backlog32")
    lo, hi = t["clips"]["windows"]["uniform_int"]
    n = t["block"]
    for seed in (SEED, SEED + 1):
        got = [s["windows"] for s in itertools.islice(gen.specs(t, seed), 4 * n)]
        for k in range(4):
            blk = sorted(got[k * n:(k + 1) * n])
            assert blk == sorted(got[:n]) and blk[0] == lo and blk[-1] == hi


def test_poisson_gaps_are_independent_draws():
    t = {"arrivals": {"poisson": 40.0}}
    g = list(itertools.islice(gen.gaps(t, SEED), 20000))
    assert abs(statistics.mean(g) - 1 / 40.0) < 0.03 / 40.0
    # arrivals in 1 s stretches: Poisson, variance equal to the mean
    times = list(itertools.accumulate(g))
    counts = [0] * int(times[-1])
    for x in times:
        if x < len(counts):
            counts[int(x)] += 1
    assert 0.7 * 40 < statistics.variance(counts) < 1.3 * 40
