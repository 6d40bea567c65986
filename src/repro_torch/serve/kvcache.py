"""Paged KV cache bookkeeping: page pool allocator + shared-prefix cache.

The ring-cache engines allocate one dense ``(L, B, C, KV, dh)`` KV
buffer per admitted wave, so two requests carrying the same prompt pay
for (and prefill) the same keys twice — exactly the waste the paper's
setting produces, where cohorts of clients in one region hit the server
with near-identical prompts. The paged layout replaces the per-wave
buffer with one per-shard pool of fixed-size *pages* on an
``(E, n_pages, ...)`` device buffer; each row owns a page table mapping
its logical cache slots to physical pages, and pages are refcounted so
prefix-sharing rows point at the *same* physical pages.

This module is the pure host-side bookkeeping half (numpy and hashlib
only, no torch): the allocator and the prefix index, an own copy of the
reference's ``serve/kvcache.py`` with the same digests, LIFO free order
and refcounts. The device half — the pooled buffers, the scatter and
the ``paged_decode_attention`` kernel that reads through page tables —
lives in ``models.attention`` / ``models.dense`` (cache protocol) and
``serve.core`` (wave machinery). Keeping the allocator free of device
state makes the refcount / free-list invariants testable in isolation
(``tests/test_torch_kvcache.py``).

Threading ownership: every structure here — ``PagePool.refs``, the
``_free`` stacks, the ``PrefixCache`` LRU — is single-writer, scheduler
thread only, and none of it is locked.

Layout contract (shared with ``EngineCore``):

  * every length bucket (and ``max_len``) is a multiple of
    ``page_size``, so prefills always fill whole pages and decode
    appends never straddle a shared partial page;
  * physical page ``n_pages`` (one past the pool) is the *trash page*:
    rows scatter into it when their compute is discarded (padding rows,
    deduplicated rows) and logical slots that are never written map to
    it. It is never allocated and never read unmasked.
"""
from __future__ import annotations

import collections
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class PagePoolExhausted(RuntimeError):
    """Raised when an admission needs more free pages than the pool
    holds (after prefix-cache eviction). The scheduler treats this as
    backpressure: the rows go back to their queues and are re-admitted
    once resident waves retire and free their pages."""


def hash_chain(tokens: np.ndarray, page: int) -> List[bytes]:
    """Cumulative page-granular prefix fingerprints.

    ``chain[j]`` identifies the *entire* token prefix through page ``j``
    (tokens ``0 .. (j+1)*page - 1``): each digest folds in the previous
    one, so two rows share ``chain[j]`` iff they share the whole
    prefix, not just the j-th page. Causal attention makes the KV
    content of page ``j`` a pure function of exactly that prefix, which
    is what lets rows with equal digests share physical pages.
    """
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out: List[bytes] = []
    prev = b""
    for j in range(len(toks) // page):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(toks[j * page:(j + 1) * page].tobytes())
        prev = h.digest()
        out.append(prev)
    return out


class PagePool:
    """Refcounted free-list allocator for ``n_experts`` independent
    per-expert page pools (the device buffer is ``(E, n_pages, ...)``;
    expert ``e`` may only hold pages from its own row of the buffer).

    Allocation is transactional: ``alloc`` either returns all ``n``
    requested pages or raises ``PagePoolExhausted`` having changed
    nothing — a failed admission can never leak pages or touch another
    row's mappings.
    """

    def __init__(self, n_experts: int, n_pages: int, page_size: int):
        if n_experts < 1 or n_pages < 1 or page_size < 1:
            raise ValueError(
                f"PagePool needs positive sizes, got E={n_experts}, "
                f"n_pages={n_pages}, page_size={page_size}")
        self.n_experts = n_experts
        self.n_pages = n_pages
        self.page = page_size
        self.refs = np.zeros((n_experts, n_pages), np.int32)
        # LIFO free stacks: recently-freed pages are reused first, which
        # keeps the hot working set small in the device buffer
        self._free: List[List[int]] = [
            list(range(n_pages - 1, -1, -1)) for _ in range(n_experts)]
        # cumulative traffic counters (obs registry): pages handed out /
        # returned over the pool's lifetime, and how many transactional
        # allocs bounced with PagePoolExhausted (the backpressure rate)
        self.page_allocs = 0
        self.page_releases = 0
        self.exhausted = 0

    @property
    def trash(self) -> int:
        """Physical index of the write-discard page (one past the pool)."""
        return self.n_pages

    def free_count(self, e: int) -> int:
        return len(self._free[e])

    def used_count(self, e: int) -> int:
        return self.n_pages - len(self._free[e])

    def counters(self) -> Dict[str, int]:
        """Pool-wide page totals: the live {free, used} conservation
        pair the scheduler's ``--check-invariants`` mode samples (free +
        used == E * n_pages always; ``check()`` proves the per-page
        books). Equality of two ``counters()`` snapshots means "no net
        page movement" — the transactional-rollback tests rely on it,
        so the monotonic traffic counters live in :meth:`telemetry`."""
        free = sum(len(f) for f in self._free)
        return {"free": free,
                "used": self.n_experts * self.n_pages - free}

    def telemetry(self) -> Dict[str, int]:
        """The obs-registry view: the live conservation pair plus the
        cumulative alloc/release traffic and how many transactional
        allocs bounced with ``PagePoolExhausted`` (the backpressure
        rate)."""
        return {**self.counters(),
                "page_allocs": self.page_allocs,
                "page_releases": self.page_releases,
                "exhausted": self.exhausted}

    def alloc(self, e: int, n: int) -> List[int]:
        """Take ``n`` pages for expert ``e`` (each at refcount 1), or
        raise ``PagePoolExhausted`` without side effects."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        free = self._free[e]
        if n > len(free):
            self.exhausted += 1
            raise PagePoolExhausted(
                f"expert {e}: need {n} pages, {len(free)} free of "
                f"{self.n_pages}")
        out = [free.pop() for _ in range(n)]
        self.refs[e, out] = 1
        self.page_allocs += n
        return out

    def retain(self, e: int, pages: Sequence[int]) -> None:
        """Add one reference to each page (prefix sharing / cache pin)."""
        for p in pages:
            if self.refs[e, p] <= 0:
                raise ValueError(f"retain of free page {p} (expert {e})")
            self.refs[e, p] += 1

    def release(self, e: int, pages: Sequence[int]) -> None:
        """Drop one reference per page; pages hitting zero return to the
        free list. Releasing a free page is an error (double free)."""
        for p in pages:
            if self.refs[e, p] <= 0:
                raise ValueError(f"double free of page {p} (expert {e})")
            self.refs[e, p] -= 1
            if self.refs[e, p] == 0:
                self._free[e].append(p)
                self.page_releases += 1

    def shared(self, e: int, page: int) -> bool:
        """True when more than one owner references the page — a row
        about to overwrite it must copy-on-write first."""
        return bool(self.refs[e, page] > 1)

    def check(self) -> None:
        """Invariant sweep (used by the property tests): every page is
        either on the free list with refcount 0 or off it with a
        positive refcount, exactly once."""
        for e in range(self.n_experts):
            free = self._free[e]
            if len(set(free)) != len(free):
                raise AssertionError(f"expert {e}: duplicate free pages")
            for p in free:
                if self.refs[e, p] != 0:
                    raise AssertionError(
                        f"expert {e}: page {p} free with refcount "
                        f"{self.refs[e, p]}")
            n_used = int((self.refs[e] > 0).sum())
            if n_used + len(free) != self.n_pages:
                raise AssertionError(
                    f"expert {e}: {n_used} used + {len(free)} free != "
                    f"{self.n_pages}")


class PrefixCache:
    """Shared-prefix index over pool pages, LRU-bounded.

    Two entry kinds, one LRU:

      * page entries ``(e, chain[j]) -> physical page`` — each holds one
        pool reference. A new row walks its own hash chain and *adopts*
        every leading page it finds (longest cached prefix), sharing
        storage with whichever row computed it first.
      * full-prompt entries ``(e, Sb, chain[-1]) -> first sampled
        token`` — when every page of a padded prompt is cached *and*
        the greedy first token is known, admission can skip the row's
        prefill compute entirely.

    Entries are inserted at harvest time (when the first token plane is
    already host-side, so registration never forces a device sync) and
    evicted LRU-first when the pool runs dry. Eviction releases the
    entry's pool reference; the page itself is freed only once live
    rows drop theirs too.
    """

    def __init__(self, pool: PagePool, capacity: int = 1024):
        self.pool = pool
        self.capacity = capacity
        self._lru: "collections.OrderedDict[tuple, int]" = \
            collections.OrderedDict()
        self.stats = {"inserts": 0, "page_hits": 0, "full_hits": 0,
                      "evictions": 0}

    def __len__(self) -> int:
        return len(self._lru)

    # -- lookup ----------------------------------------------------------
    def adopt_prefix(self, e: int, chain: Sequence[bytes]) -> List[int]:
        """Longest cached prefix of ``chain``: returns the physical
        pages (pool references already added for the caller, who owns
        them from here on)."""
        pages: List[int] = []
        for h in chain:
            got = self._lru.get(("pg", e, h))
            if got is None:
                break
            pages.append(got)
            self._lru.move_to_end(("pg", e, h))
        if pages:
            self.pool.retain(e, pages)
            self.stats["page_hits"] += len(pages)
        return pages

    def first_token(self, e: int, padded_len: int,
                    chain: Sequence[bytes]) -> Optional[int]:
        """The greedy first token for a fully-cached padded prompt, or
        None when unknown (row must be prefilled)."""
        if not chain:
            return None
        key = ("tok", e, padded_len, chain[-1])
        got = self._lru.get(key)
        if got is not None:
            self._lru.move_to_end(key)
            self.stats["full_hits"] += 1
        return got

    # -- insert / evict --------------------------------------------------
    def insert(self, e: int, padded_len: int, chain: Sequence[bytes],
               pages: Sequence[int], first_token: Optional[int]) -> None:
        """Register a computed row's prefix pages (one pool reference
        per newly-indexed page) and, when the whole padded prompt is
        covered, its greedy first token."""
        assert len(pages) == len(chain)
        for h, p in zip(chain, pages):
            key = ("pg", e, h)
            if key in self._lru:
                self._lru.move_to_end(key)
                continue
            self.pool.retain(e, [p])
            self._lru[key] = p
            self.stats["inserts"] += 1
        if first_token is not None and chain:
            self._lru[("tok", e, padded_len, chain[-1])] = int(first_token)
        self._trim(self.capacity)

    def _drop(self, key: tuple) -> None:
        val = self._lru.pop(key)
        if key[0] == "pg":
            self.pool.release(key[1], [val])
        self.stats["evictions"] += 1

    def _trim(self, limit: int) -> None:
        while len(self._lru) > limit:
            self._drop(next(iter(self._lru)))

    def evict_for(self, e: int, need: int) -> None:
        """Drop LRU entries of expert ``e`` until its pool has ``need``
        free pages or nothing evictable remains. Dropping an entry only
        *releases* its reference; pages still pinned by live rows free
        up when those waves retire."""
        if self.pool.free_count(e) >= need:
            return
        for key in [k for k in self._lru if k[1] == e]:
            self._drop(key)
            if self.pool.free_count(e) >= need:
                return

    def invalidate(self, e: int) -> None:
        """Drop every entry of expert ``e`` — its slot is being recycled
        for a different expert (expert-hub eviction), so its cached prefixes
        describe KV content that is about to be overwritten."""
        for key in [k for k in self._lru if k[1] == e]:
            self._drop(key)

    def clear(self) -> None:
        self._trim(0)
