"""Routing front-end: ExpertMatcher + the routing kernels + a fingerprint
cache.

  * routing batches snap to power-of-two row buckets, so the set of
    shapes the scoring kernels see stays bounded under arbitrary traffic;
  * fine assignment encodes each routed-expert *group* only under its
    own expert (padded to its row bucket); the encoded rows of every
    group of a route chunk then go through ONE ``cosine_fine`` launch,
    which scores each row against its own expert's centroids and takes
    the argmax, and one device-to-host copy brings the classes back;
  * routing decisions are memoized per client fingerprint in an LRU:
    clients in the paper's setting re-query with the same fingerprint.

Coarse scoring honours ``MatcherConfig``: ``use_kernel=True`` scores
through the ``expert_score`` kernel, otherwise the plain bank math.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import autoencoder as ae
from ..core.matcher import ExpertMatcher
from ..kernels.cosine_topk import cosine_fine
from .core import bucket_for, make_buckets


@dataclasses.dataclass
class RouteResult:
    coarse: np.ndarray        # (B, top_k) expert indices, best first
    coarse_score: np.ndarray  # (B, top_k) scores (lower = better)
    fine: np.ndarray          # (B,) class index within the top-1 expert
    shard: Optional[np.ndarray] = None  # (B,) placement shard ids
    cache_hits: int = 0


class PrefixLRU:
    """Prompt-prefix index: the fingerprint-LRU idiom applied to prompt
    pages. ``observe`` fingerprints the first ``page`` tokens of each
    prompt and returns a grouping key; the LRU's repeat counter is the
    cohort-detection signal surfaced in routing stats."""

    def __init__(self, page: int = 8, capacity: int = 4096):
        self.page = page
        self.capacity = capacity
        self._lru: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        self.stats = {"observed": 0, "repeats": 0}

    def observe(self, prompt: np.ndarray) -> bytes:
        head = np.ascontiguousarray(
            np.asarray(prompt, np.int32)[:self.page]).tobytes()
        key = hashlib.blake2b(head, digest_size=16).digest()
        self.stats["observed"] += 1
        seen = self._lru.pop(key, 0)
        if seen:
            self.stats["repeats"] += 1
        self._lru[key] = seen + 1
        while len(self._lru) > self.capacity:
            self._lru.popitem(last=False)
        return key


class Router:
    """Batch router with bounded shapes and a fingerprint LRU.

    ``shard_of`` (expert index -> shard id, from a ``PlacementPlan``)
    makes every ``RouteResult`` carry the shard serving each row. Shard
    ids are derived from the top-1 expert after the LRU, so cached
    decisions stay placement-agnostic.
    """

    def __init__(self, matcher: ExpertMatcher, *, cache_size: int = 4096,
                 use_fine_kernel: bool = True, max_rows: int = 256,
                 shard_of: Optional[Dict[int, int]] = None):
        self.matcher = matcher
        self.shard_of = dict(shard_of) if shard_of is not None else None
        self.device = matcher.device
        self.use_fine_kernel = use_fine_kernel and \
            matcher.centroids is not None
        self.row_buckets = make_buckets(1, max_rows)
        self._lru: "collections.OrderedDict[bytes, tuple]" = \
            collections.OrderedDict()
        self.cache_size = cache_size
        self.stats = {"routed": 0, "cache_hits": 0, "score_calls": 0}
        # per-expert top-1 hit counts: the popularity signal the expert
        # hub's eviction reads (ExpertHub.bind_popularity shares this very
        # Counter and points hits_lock at the hub lock)
        self.expert_hits: collections.Counter = collections.Counter()
        self.hits_lock: Optional[threading.Lock] = None

    def _encode_at(self, x: torch.Tensor, e: int) -> torch.Tensor:
        """Encode a group under ONE expert's AE."""
        m = self.matcher
        params = {k: v[e] for k, v in m.bank_params.items()}
        state = {k: v[e] for k, v in m.bank_states.items()}
        return ae.encode(params, state, x)

    # ------------------------------------------------------------------
    def _pad_rows(self, x: np.ndarray) -> Tuple[np.ndarray, int]:
        n = len(x)
        nb = bucket_for(n, self.row_buckets)
        if nb > n:
            x = np.concatenate([x, np.zeros((nb - n,) + x.shape[1:],
                                            x.dtype)])
        return x, n

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _fine_grouped(self, x: np.ndarray,
                      coarse_top1: np.ndarray) -> np.ndarray:
        """Fine assignment of one route chunk: each expert group padded
        to its row bucket and encoded under its own expert, then one
        ``cosine_fine`` launch over every group's rows and one copy of
        the classes to the host. ``score_calls`` counts groups."""
        m = self.matcher
        groups, xs, experts = [], [], []
        off = 0
        for e in np.unique(coarse_top1):
            rows = np.nonzero(coarse_top1 == e)[0]
            xg, _ = self._pad_rows(x[rows])
            groups.append((int(e), rows, off, len(xg)))
            xs.append(xg)
            experts.append(np.full(len(xg), e, np.int32))
            off += len(xg)
            self.stats["score_calls"] += 1
        xd = self._to_device(np.concatenate(xs))
        z = torch.cat([self._encode_at(xd[o:o + nb], e)
                       for e, _, o, nb in groups])
        _, cls = cosine_fine(z, m.centroids, m.centroid_mask,
                             self._to_device(np.concatenate(experts)))
        cls = cls.cpu().numpy()
        fine = np.zeros(len(x), np.int64)
        for _, rows, o, _ in groups:
            fine[rows] = cls[o:o + len(rows)]
        return fine

    # ------------------------------------------------------------------
    def route(self, feats: np.ndarray) -> RouteResult:
        """feats: (B, 784) float32 fingerprints -> routing decisions."""
        feats = np.asarray(feats, np.float32)
        B = len(feats)
        top_k = self.matcher.config.top_k
        coarse = np.zeros((B, top_k), np.int64)
        score = np.zeros((B, top_k), np.float32)
        fine = np.zeros(B, np.int64)

        keys = [f.tobytes() for f in feats]
        miss = []
        hits = 0
        for i, k in enumerate(keys):
            got = self._lru.get(k)
            if got is not None:
                coarse[i], score[i], fine[i] = got
                self._lru.move_to_end(k)
                hits += 1
            else:
                miss.append(i)

        # chunk misses to the largest row bucket
        step = self.row_buckets[-1]
        for lo in range(0, len(miss), step):
            chunk = miss[lo:lo + step]
            xm = feats[chunk]
            xp, n = self._pad_rows(xm)
            xp = self._to_device(xp)
            c, s = self.matcher.assign_coarse_topk(xp)
            c = c.cpu().numpy()[:n]
            s = s.cpu().numpy()[:n]
            if self.use_fine_kernel:
                f = self._fine_grouped(xm, c[:, 0])
            elif self.matcher.centroids is not None:
                top1 = torch.from_numpy(
                    np.pad(c[:, 0], (0, len(xp) - n))).to(self.device)
                f = self.matcher.assign_fine(xp, top1).cpu().numpy()[:n]
            else:
                f = np.zeros(n, np.int64)
            for j, i in enumerate(chunk):
                coarse[i], score[i], fine[i] = c[j], s[j], f[j]
                self._remember(keys[i], (c[j], s[j], f[j]))

        self.stats["routed"] += B
        self.stats["cache_hits"] += hits
        with (self.hits_lock if self.hits_lock is not None
              else contextlib.nullcontext()):
            for e in coarse[:, 0]:
                self.expert_hits[int(e)] += 1
        shard = None
        if self.shard_of is not None:
            shard = np.asarray([self.shard_of.get(int(e), -1)
                                for e in coarse[:, 0]], np.int64)
        return RouteResult(coarse, score, fine, shard=shard,
                           cache_hits=hits)

    def _remember(self, key: bytes, value) -> None:
        # copy: the (c, s) rows are views into a whole routed chunk
        c, s, f = value
        self._lru[key] = (np.array(c, np.int64), np.array(s, np.float32),
                          int(f))
        if len(self._lru) > self.cache_size:
            self._lru.popitem(last=False)
