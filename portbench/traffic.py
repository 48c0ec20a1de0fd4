"""The benchmark's traffic generator: one general generator for every mix.

A mix is a JSON file under ``traffic/`` (see ``load``).  Everything a run
offers the program is drawn here from ``--seed``; the program receives
only token ids, lengths and churn events.

Every seed gets the same work in another order, so that two seeds differ
by about as much as two runs of one seed:

* the closed loop's ``clients`` each walk one fixed set of (prompt,
  output) length pairs, taken at fixed quantiles of the clipped lognormal
  laws, from a start drawn from the seed (``Requests``); token ids are
  uniform over the vocabulary;
* churn ticks follow the AR(1) uplink fade and the node-outage chain of
  the online regime (``core/scenarios.churn_trace`` in the program), with
  the randomness stratified the same way: each block of 64 ticks takes
  its 64 fade innovations at fixed normal quantiles in a seeded order, and
  each block of ``round(1 / p_fail)`` ticks holds one outage, at a seeded
  tick, whose length cycles through eight fixed quantiles of the
  geometric law of ``p_recover`` in a seeded order.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import List, Optional

import numpy as np

#: the fixed pairing of the prompt and output quantiles
_PAIRING_SEED = 20240108


def load(path: Path) -> dict:
    """A traffic mix: ``clients`` (the closed loop's clients, which is also
    the engine's batch), ``prompt_tokens`` / ``output_tokens`` (lognormal
    ``median``, ``sigma``, ``min``, ``max``), ``warmup_steps``, and
    ``churn`` (null, or the tick parameters of ``ChurnTicks``)."""
    mix = json.loads(Path(path).read_text())
    for key in ("clients", "prompt_tokens", "output_tokens", "warmup_steps"):
        if key not in mix:
            raise ValueError(f"{path}: traffic mix lacks {key!r}")
    return mix


def lognormal_quantiles(law: dict, n: int) -> List[int]:
    """The ``n`` lengths at quantiles (j + 1/2) / n of a lognormal law of
    ``median`` and ``sigma``, rounded and clipped to [min, max]."""
    nd = NormalDist()
    mu = math.log(law["median"])
    out = []
    for j in range(n):
        z = nd.inv_cdf((j + 0.5) / n)
        v = int(round(math.exp(mu + law["sigma"] * z)))
        out.append(min(law["max"], max(law["min"], v)))
    return out


@dataclass
class RequestSpec:
    index: int                 # order of submission
    client: int
    prompt: List[int]
    max_new_tokens: int


def _stride(n: int) -> int:
    """A step through n pairs, coprime to n, near n / golden ratio, so a
    client's successive requests spread over the whole law."""
    k = max(1, round(0.618 * n))
    while math.gcd(k, n) != 1:
        k += 1
    return k


class Requests:
    """The closed loop's request stream.  Each client walks the mix's
    ``clients`` length pairs (taken at fixed quantiles of the two laws,
    paired by a fixed permutation) with a fixed stride, from a start drawn
    from the seed; ``next(client)`` gives that client's next request, with
    its ids drawn from the seed.  Every seed thus serves the same pairs,
    the same number of times, in another order of clients."""

    def __init__(self, mix: dict, seed: int, vocab_size: int):
        self.clients = int(mix["clients"])
        prompts = lognormal_quantiles(mix["prompt_tokens"], self.clients)
        outs = lognormal_quantiles(mix["output_tokens"], self.clients)
        pair = np.random.default_rng(_PAIRING_SEED).permutation(self.clients)
        self.pairs = [(prompts[j], outs[int(pair[j])])
                      for j in range(self.clients)]
        self.vocab_size = int(vocab_size)
        self._rng = np.random.default_rng(seed)
        self._start = self._rng.permutation(self.clients)
        self._stride = _stride(self.clients)
        self._taken = [0] * self.clients
        self._count = 0

    def next(self, client: int) -> RequestSpec:
        k = self._taken[client]
        self._taken[client] += 1
        j = (int(self._start[client]) + k * self._stride) % self.clients
        n_prompt, n_out = self.pairs[j]
        ids = self._rng.integers(0, self.vocab_size, n_prompt)
        spec = RequestSpec(self._count, client, [int(t) for t in ids], n_out)
        self._count += 1
        return spec


def geometric_quantiles(p: float, n: int) -> List[int]:
    """The ``n`` outage lengths (ticks, >= 1) at quantiles (j + 1/2) / n of
    the geometric law of a recovery chance ``p`` a tick."""
    return [max(1, math.ceil(math.log(1.0 - (j + 0.5) / n)
                             / math.log(1.0 - p))) for j in range(n)]


class ChurnTicks:
    """Churn ticks for the single-user engine, as (kind, node or None,
    value) tuples: one ``("uplink", 0, q)`` a tick, where q is the AR(1)
    quality factor on ``uplink_bps``, and ``("fail", None, n)`` /
    ``("recover", None, n)`` for the nodes of ``fail_nodes``, which fail
    and recover together."""

    FADE_BLOCK = 64
    OUTAGE_CYCLE = 8

    def __init__(self, churn: dict, seed: int):
        self.p = churn
        self._rng = np.random.default_rng([seed, 1])
        self.q = float(churn["q_mean"])
        nd = NormalDist()
        self._innov = [churn["sigma"] * nd.inv_cdf((j + 0.5) / self.FADE_BLOCK)
                       for j in range(self.FADE_BLOCK)]
        self._fade: List[float] = []
        self.block = max(1, int(round(1.0 / churn["p_fail"])))
        self._lengths = geometric_quantiles(churn["p_recover"],
                                            self.OUTAGE_CYCLE)
        self._cycle: List[int] = []
        self._tick = 0
        self._down_until: Optional[int] = None     # tick of the recovery
        self._next_fail = self._draw_fail(0)

    def _draw_fail(self, block_start: int) -> int:
        return block_start + int(self._rng.integers(self.block))

    def _outage_length(self) -> int:
        if not self._cycle:
            order = self._rng.permutation(self.OUTAGE_CYCLE)
            self._cycle = [self._lengths[int(j)] for j in order]
        return self._cycle.pop()

    def next(self) -> List[tuple]:
        c = self.p
        if not self._fade:
            order = self._rng.permutation(self.FADE_BLOCK)
            self._fade = [self._innov[int(j)] for j in order]
        self.q = min(c["q_hi"], max(c["q_lo"], c["q_mean"] + c["rho"]
                                    * (self.q - c["q_mean"])
                                    + self._fade.pop()))
        t = self._tick
        events: List[tuple] = [("uplink", 0, self.q)]
        if self._down_until is not None and t >= self._down_until:
            events += [("recover", None, int(n)) for n in c["fail_nodes"]]
            self._down_until = None
        if self._down_until is None and t >= self._next_fail:
            events += [("fail", None, int(n)) for n in c["fail_nodes"]]
            self._down_until = t + self._outage_length()
            start = (t // self.block + 1) * self.block
            self._next_fail = max(self._draw_fail(start),
                                  self._down_until + 1)
        self._tick += 1
        return events


