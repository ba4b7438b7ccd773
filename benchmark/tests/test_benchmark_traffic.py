"""The traffic generator: a seed gives its requests again, every seed
offers the same sizes and gaps, and a stratified order gives every run of
``order_block`` arrivals one entry of each stratum."""

import numpy as np
import pytest

from benchmark import harness, traffic

MIX = harness.resolve(harness.load_benchmark(),
                      "mixtral-8x7b.serve.chat").mix


def _sizes(reqs):
    return (sorted(len(r["prompt"]) for r in reqs),
            sorted(r["max_new"] for r in reqs))


def test_a_seed_gives_the_same_requests_again():
    seed = 2**31 + 12345
    a = traffic.serve_requests(MIX, seed, 32000, 30.0)
    b = traffic.serve_requests(MIX, seed, 32000, 30.0)
    assert [r["due"] for r in a] == [r["due"] for r in b]
    assert all(np.array_equal(x["prompt"], y["prompt"]) for x, y in zip(a, b))


def test_seeds_offer_the_same_sizes_in_another_order():
    a = traffic.serve_requests(MIX, 7, 32000, 60.0)
    b = traffic.serve_requests(MIX, 8, 32000, 60.0)
    # the horizon cuts the last arrival or two, which the seed picks
    for x, y in zip(_sizes(a), _sizes(b)):
        assert len(set(x) ^ set(y)) <= 4 and abs(len(x) - len(y)) <= 2
    assert [r["max_new"] for r in a] != [r["max_new"] for r in b]
    assert all(x["due"] <= y["due"] for x, y in zip(a, a[1:]))
    assert a[0]["due"] == -MIX["ramp_s"] and a[-1]["due"] <= 60.0


@pytest.mark.parametrize("block", [1, 8, 13])
def test_each_run_of_a_stratified_order_holds_one_of_each_stratum(block):
    values = np.arange(100) * 3.0
    got = traffic.stratified(values, np.random.default_rng(3), block)
    assert sorted(got) == sorted(values)
    if block <= 1:
        return
    runs = -(-len(values) // block)
    stratum = {v: int(i // runs) for i, v in enumerate(np.sort(values))}
    seen = []
    for v in got:
        if seen and stratum[v] in seen or len(seen) == block:
            seen = []
        assert stratum[v] not in seen
        seen.append(stratum[v])


def test_stratified_runs_carry_the_same_load():
    gaps = -np.log(1.0 - (np.arange(400) + 0.5) / 400)
    rng = np.random.default_rng(11)
    loose = rng.permutation(gaps).reshape(50, 8).sum(1)
    tight = traffic.stratified(gaps, rng, 8).reshape(50, 8).sum(1)
    assert tight.std() < 0.5 * loose.std()
