"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and makes its requests from ``--seed``.

Every seed gets the same work.  Sizes and gaps are not drawn at random
but taken at evenly spaced quantiles of their distributions (a pool of
fixed values); the seed draws the token ids.

Open loop (``"loop": "open"``): arrivals at ``rate_per_s``.  The window
holds ``round(rate * seconds)`` arrivals whose gaps add up to the
window's length exactly; a pre-roll of ``pre_s`` seconds before it fills
the queue, and arrivals go on after it (in further cycles of the same
pool) until the window's requests have finished.  Times are relative to
the window's opening.  The pools are put in order once, by the mix's own
``schedule_seed``, so every run replays one schedule: with some tens of
requests in a window, the order alone (which long prompts arrive close
together) moved the p90 of TTFT by more than twice between seeds.

Closed loop (``"loop": "closed"``): ``clients`` clients, each sending its
next request the moment the previous one has come back.  The pool holds
one value per client; in each round the seed deals it out among the
clients, so every round asks for the same work.

Length distributions: ``{"dist": "uniform", "min", "max"}`` or
``{"dist": "lognormal", "mean", "sigma", "min", "max"}`` (clipped; the
median is the one whose clipped pool has that mean, so a pool keeps a
trace's published mean at any pool size).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class Item:
    """One request to send: its due time (open loop, seconds from the
    window's opening), prompt ids and the number of tokens to serve."""
    due: float
    tokens: np.ndarray
    out_len: int
    cycle: int


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def length_pool(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at evenly spaced quantiles of ``spec``'s distribution."""
    q = _quantiles(n)
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        vals = lo + (hi - lo) * q
    elif spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in q])

        def pool(log_median: float) -> np.ndarray:
            return np.clip(np.rint(np.exp(log_median + spec["sigma"] * z)), lo, hi)

        # the median whose clipped pool has the mean: the pool's mean grows
        # with the median, so bisect on it
        a, b = math.log(lo), math.log(hi)
        for _ in range(60):
            mid = (a + b) / 2
            a, b = (mid, b) if pool(mid).mean() < spec["mean"] else (a, mid)
        return pool(b).astype(np.int64)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def gap_pool(rate: float, n: int, total: float) -> np.ndarray:
    """``n`` exponential gaps at evenly spaced quantiles, scaled to add up
    to ``total`` seconds (a Poisson process of ``rate`` with its count fixed)."""
    gaps = -np.log1p(-_quantiles(n)) / rate
    return gaps * (total / gaps.sum())


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), *stream]))


class Traffic:
    def __init__(self, spec: dict, vocab: int, seed: int, seconds: float):
        self.spec = spec
        self.vocab = vocab
        self.seed = seed
        self.seconds = float(seconds)
        self.loop = spec["loop"]
        if self.loop not in ("open", "closed"):
            raise ValueError(f"loop must be open or closed, got {self.loop!r}")

    def _ids(self, n: int, *stream: int) -> np.ndarray:
        return _rng(self.seed, 1, *stream).integers(0, self.vocab, size=n, dtype=np.int32)

    # ---- open loop ---------------------------------------------------------
    @property
    def window_count(self) -> int:
        return max(1, round(self.spec["rate_per_s"] * self.seconds))

    def _cycle(self, cycle: int, n: int, total: float, t0: float) -> list:
        rate = self.spec["rate_per_s"]
        rng = _rng(int(self.spec["schedule_seed"]), 0, cycle)
        gaps = rng.permutation(gap_pool(rate, n, total))
        prompts = rng.permutation(length_pool(self.spec["prompt"], n))
        outs = rng.permutation(length_pool(self.spec["output"], n))
        due = t0 + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        return [Item(float(due[i]), self._ids(int(prompts[i]), cycle, i),
                     int(outs[i]), cycle) for i in range(n)]

    def arrivals(self) -> Iterator[Item]:
        """Open-loop arrivals in due order, without end: cycle 0 is the
        pre-roll, cycle 1 the window, later cycles follow it."""
        pre = float(self.spec.get("pre_s", 0.0))
        rate = self.spec["rate_per_s"]
        if pre > 0:
            yield from self._cycle(0, max(1, round(rate * pre)), pre, -pre)
        cycle = 1
        while True:
            t0 = (cycle - 1) * self.seconds
            yield from self._cycle(cycle, self.window_count, self.seconds, t0)
            cycle += 1

    # ---- closed loop -------------------------------------------------------
    def client(self, c: int) -> Iterator[Item]:
        """Client ``c``'s requests, in the order it sends them: its share
        of each round's deal."""
        n = int(self.spec["clients"])
        prompts, outs = length_pool(self.spec["prompt"], n), length_pool(self.spec["output"], n)
        k = 0
        while True:
            rng = _rng(self.seed, 2, k)
            p, o = rng.permutation(n)[c], rng.permutation(n)[c]
            yield Item(0.0, self._ids(int(prompts[p]), 3, c, k), int(outs[o]), k)
            k += 1
