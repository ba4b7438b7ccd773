"""The one traffic generator: a mix file's parameters and a seed in, the
requests or batches of a run out.

Every seed gets the same multiset of sizes and gaps, in another order:
lengths sit at evenly spaced quantiles of their distribution and the
gaps of an open-loop Poisson arrival process at evenly spaced quantiles
of the exponential, and the seed orders each and draws the token ids.
So two seeds offer the same work, and the seed moves only which request
comes when. A serving mix may set ``order_block``: the order is then
stratified (:func:`stratified`), so that every stretch of that many
arrivals offers the same load, and the seed no longer moves how much
work lands in one stretch of the window. That smooths the arrivals: the
bursts of a Poisson process are taken out, and a tail read under such a
mix is a smoothed-arrival tail.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np


def quantiles(spec: Dict, n: int) -> np.ndarray:
    """``n`` integer lengths at the quantiles (i + 0.5) / n of the
    distribution ``spec``: ``{"dist": "lognormal", "median", "sigma",
    "min", "max"}`` (clipped) or ``{"dist": "uniform", "min", "max"}``."""
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in u])
        vals = spec["median"] * np.exp(spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        vals = spec["min"] + u * (spec["max"] - spec["min"])
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


def stratified(values: np.ndarray, rng: np.random.Generator, block: int
               ) -> np.ndarray:
    """``values`` in an order drawn from ``rng`` in which each run of
    ``block`` consecutive entries holds one entry of each of ``block``
    strata of the sorted values (the runs short of an entry, where
    ``block`` does not divide their number, are drawn from the seed). The
    seed picks which member of a stratum lands in which run, and the
    order inside each run. ``block`` 0 or 1: one shuffle of the whole."""
    n = len(values)
    if block <= 1 or block >= n:
        return rng.permutation(values)
    runs = -(-n // block)
    ranked = np.sort(values)
    slots = np.full(runs * block, -1)
    slots[:n] = np.arange(n)
    # row r is stratum r: the ranked entries r * runs to (r + 1) * runs
    grid = np.stack([row[rng.permutation(runs)]
                     for row in slots.reshape(block, runs)])
    order = [i for j in range(runs)
             for i in grid[rng.permutation(block), j] if i >= 0]
    return ranked[np.asarray(order)]


def serve_requests(mix: Dict, seed: int, vocab: int, horizon_s: float
                   ) -> List[Dict]:
    """Requests of an open-loop mix, sorted by when they are due. Times
    are seconds from the window's opening: arrivals start ``ramp_s``
    before it and run to ``horizon_s`` after it. Each request is
    ``{"due", "prompt" (int32 ids, uniform over the vocabulary),
    "max_new"}``."""
    rate = float(mix["rate_per_s"])
    span = mix["ramp_s"] + horizon_s
    n = int(math.ceil(rate * span)) + 1
    rng = np.random.default_rng(int(seed) % 2**63)
    block = int(mix.get("order_block", 0))
    gaps = stratified(-np.log(1.0 - (np.arange(n) + 0.5) / n) / rate, rng,
                      block)
    due = -mix["ramp_s"] + np.cumsum(gaps) - gaps[0]
    prompts = stratified(quantiles(mix["prompt"], n), rng, block)
    outputs = stratified(quantiles(mix["output"], n), rng, block)
    reqs = []
    for t, p, o in zip(due, prompts, outputs):
        if t > horizon_s:
            break
        reqs.append({"due": float(t), "max_new": int(o),
                     "prompt": rng.integers(0, vocab, size=int(p),
                                            dtype=np.int32)})
    return reqs


def sample(rng_seed: int, candidates: List[int], sizes: List[int],
           min_tokens: int, max_count: int) -> List[int]:
    """Indices into ``candidates`` for the output check: the one with the
    largest size first, then others in an order drawn from the seed until
    their sizes reach ``min_tokens`` or ``max_count`` are taken."""
    if not candidates:
        return []
    rng = np.random.default_rng((int(rng_seed) + 1) % 2**63)
    order = list(rng.permutation(len(candidates)))
    top = int(np.argmax(sizes))
    picked = [top]
    total = sizes[top]
    for i in order:
        if total >= min_tokens or len(picked) >= max_count:
            break
        if i != top:
            picked.append(int(i))
            total += sizes[i]
    return picked


def train_deck(mix: Dict, seed: int, vocab: int, device):
    """``deck_batches`` batches of token ids [B, T + 1] (int32, uniform
    over the vocabulary), made on the device in one call from the seed."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    shape = (mix["deck_batches"], mix["batch"], mix["seq"] + 1)
    return torch.randint(0, vocab, shape, generator=gen, device=device,
                         dtype=torch.int32)
