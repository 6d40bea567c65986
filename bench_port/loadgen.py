"""The traffic generator: a mix file (``traffic/<name>.json``) holds only
parameters, and ``Traffic`` turns them and the seed into requests.

A mix is a closed loop of jobs: ``job_requests`` requests submitted at
once, the next job when the last response of the one before is
harvested, ``warmup_jobs`` of them before the window. Its keys:

* ``prompt_tokens``, ``new_tokens``: ``{"dist": "lognormal", "median",
  "sigma", "min", "max"}``;
* ``pairing_seed``: which prompt length goes with which answer length
  and expert (the same for every run);
* ``name``, ``why``, ``assumed``: words for the reader.

Experts are uniform over the fleet, and every fingerprint is fresh. A mix
that needs anything else (arrivals, skew, shared prefixes) comes with the
generator code that reads it: a key this file does not know is refused.

Every seed gets the same sizes, in another order: the lengths are the
distribution's quantiles at (i + 0.5) / n, paired by a fixed permutation
of the mix; the seed orders them and draws the token ids and
fingerprints. So two seeds do the same work, and differ in what it is.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List

import numpy as np

from . import synth
from .fleet import stream

_NORMAL = statistics.NormalDist()
KEYS = {"name", "why", "assumed", "job_requests", "warmup_jobs",
        "prompt_tokens", "new_tokens", "pairing_seed"}


@dataclasses.dataclass
class Spec:
    """One request as generated: the expert whose dataset its fingerprint
    comes from, the prompt and the tokens asked for."""
    uid: int
    expert: int
    prompt: np.ndarray
    max_new: int
    features: np.ndarray


def quantiles(d: Dict[str, Any], n: int) -> np.ndarray:
    """``n`` lengths at the lognormal's quantiles (i + 0.5) / n."""
    if d["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {d['dist']!r}")
    u = (np.arange(n) + 0.5) / n
    z = np.array([_NORMAL.inv_cdf(float(x)) for x in u])
    v = d["median"] * np.exp(d["sigma"] * z)
    return np.clip(np.rint(v), d["min"], d["max"]).astype(np.int64)


def expert_table(n: int, n_experts: int) -> np.ndarray:
    """Experts of ``n`` requests, uniform: the first ``n % n_experts``
    experts take one more, laid out in expert order."""
    cnt = np.full(n_experts, n // n_experts)
    cnt[:n % n_experts] += 1
    return np.repeat(np.arange(n_experts), cnt)


def shapes(mix: Dict[str, Any], n: int, n_experts: int) -> np.ndarray:
    """The mix's fixed (prompt, new tokens, expert) table of ``n`` rows:
    the same for every seed."""
    pair = np.random.default_rng(int(mix.get("pairing_seed", 0)))
    prompt = quantiles(mix["prompt_tokens"], n)
    new = quantiles(mix["new_tokens"], n)[pair.permutation(n)]
    expert = expert_table(n, n_experts)[pair.permutation(n)]
    return np.stack([prompt, new, expert], axis=1)


class Traffic:
    """The requests of one run of mix ``mix`` on a fleet of ``names``
    (datasets, expert order) with token ids below ``vocab``."""

    def __init__(self, mix: Dict[str, Any], names: List[str], vocab: int,
                 seed: int):
        unknown = set(mix) - KEYS
        if unknown:
            raise ValueError(f"mix {mix.get('name')!r}: keys this generator "
                             f"does not read: {sorted(unknown)}")
        self.mix, self.names, self.vocab, self.seed = mix, names, vocab, seed
        self.warmup_jobs = int(mix.get("warmup_jobs", 1))
        self._uid = 0

    def job(self, j: int) -> List[Spec]:
        """Job ``j`` (0 .. warmup_jobs - 1 are the warm-up's): the mix's
        table in the order that the seed and ``j`` give."""
        n = int(self.mix["job_requests"])
        table = shapes(self.mix, n, len(self.names))
        key = 1000 + j
        rng = np.random.default_rng(stream(self.seed, 10, key))
        rows = table[rng.permutation(n)]
        prompts = [rng.integers(0, self.vocab, size=int(p)).astype(np.int32)
                   for p in rows[:, 0]]
        feats = self._features(rows[:, 2], key)
        out = []
        for i, (_, new, e) in enumerate(rows):
            self._uid += 1
            out.append(Spec(self._uid, int(e), prompts[i], int(new),
                            feats[i]))
        return out

    def _features(self, experts: np.ndarray, key: int) -> np.ndarray:
        feats = np.zeros((len(experts), 784), np.float32)
        for e in np.unique(experts):
            idx = np.flatnonzero(experts == e)
            x, _ = synth.draw(self.names[int(e)], len(idx),
                              stream(self.seed, 11, key, int(e)) % 2**32)
            feats[idx] = x
        return feats
