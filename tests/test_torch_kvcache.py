"""The port's own copy of the paged-KV bookkeeping (``serve/kvcache.py``)
against the reference's: the same sequence of alloc, retain, release,
adopt, insert and evict gives equal digests, page ids, refcounts,
counters and telemetry, and the same transactional PagePoolExhausted."""
import numpy as np
import pytest

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro.serve import kvcache as jkv
from repro_torch.serve import kvcache as tkv


def _state(mod_pool, cache):
    return (mod_pool.refs.copy(), [list(f) for f in mod_pool._free],
            mod_pool.counters(), mod_pool.telemetry(), dict(cache.stats),
            list(cache._lru.items()))


def _assert_same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]


@pytest.mark.parametrize("page", [4, 8, 16])
def test_hash_chain_digests_equal(page):
    rng = np.random.default_rng(page)
    for n in (0, page - 1, page, 3 * page + 1, 64):
        toks = rng.integers(0, 50_000, size=n).astype(np.int32)
        assert tkv.hash_chain(toks, page) == jkv.hash_chain(toks, page)
    # cumulative: equal heads give equal digests, a change later doesn't
    a = np.arange(4 * page, dtype=np.int32)
    b = a.copy()
    b[-1] += 1
    ca, cb = tkv.hash_chain(a, page), tkv.hash_chain(b, page)
    assert ca[:-1] == cb[:-1] and ca[-1] != cb[-1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_sequence_matches_reference(seed):
    """One random stream of allocator and prefix-cache operations driven
    through both copies; the books agree after every step."""
    rng = np.random.default_rng(seed)
    E, n_pages, page = 2, 24, 8
    pools = (jkv.PagePool(E, n_pages, page), tkv.PagePool(E, n_pages, page))
    caches = (jkv.PrefixCache(pools[0], capacity=20),
              tkv.PrefixCache(pools[1], capacity=20))
    held = {e: [] for e in range(E)}        # one entry per reference
    prompts = [rng.integers(0, 30, size=3 * page).astype(np.int32)
               for _ in range(4)]
    prompts.append(np.concatenate([prompts[0][:page],
                                   prompts[1][page:]]))   # shared head
    for step in range(120):
        e = int(rng.integers(E))
        op = rng.random()
        if op < 0.3:
            n = int(rng.integers(0, n_pages // 2 + 3))
            outs = []
            for pool in pools:
                try:
                    outs.append(pool.alloc(e, n))
                except tkv.PagePoolExhausted:
                    outs.append("exhausted")
                except jkv.PagePoolExhausted:
                    outs.append("exhausted")
            assert outs[0] == outs[1], step
            if outs[0] != "exhausted":
                held[e] += outs[0]
        elif op < 0.45 and held[e]:
            pg = held[e][int(rng.integers(len(held[e])))]
            for pool in pools:
                pool.retain(e, [pg])
            held[e].append(pg)
        elif op < 0.6 and held[e]:
            pg = held[e].pop(int(rng.integers(len(held[e]))))
            for pool in pools:
                pool.release(e, [pg])
        elif op < 0.75:
            toks = prompts[int(rng.integers(len(prompts)))]
            chain = tkv.hash_chain(toks, page)
            got = [c.adopt_prefix(e, chain) for c in caches]
            assert got[0] == got[1], step
            held[e] += got[0]
            tok = [c.first_token(e, len(toks), chain) for c in caches]
            assert tok[0] == tok[1]
        elif op < 0.9:
            toks = prompts[int(rng.integers(len(prompts)))]
            chain = tkv.hash_chain(toks, page)
            if pools[0].free_count(e) >= len(chain):
                pages = pools[0].alloc(e, len(chain))
                assert pools[1].alloc(e, len(chain)) == pages
                ft = int(rng.integers(100))
                for c in caches:
                    c.insert(e, len(toks), chain, pages, ft)
                held[e] += pages
        else:
            need = int(rng.integers(1, n_pages))
            for c in caches:
                c.evict_for(e, need)
        _assert_same(_state(pools[0], caches[0]), _state(pools[1], caches[1]))
        pools[1].check()
    for e in range(E):
        for pg in held[e]:
            for pool in pools:
                pool.release(e, [pg])
    for c in caches:
        c.clear()
    _assert_same(_state(pools[0], caches[0]), _state(pools[1], caches[1]))
    assert pools[1].counters() == {"free": E * n_pages, "used": 0}


def test_exhaustion_is_transactional_and_errors_match():
    jp, tp = jkv.PagePool(1, 4, 8), tkv.PagePool(1, 4, 8)
    assert jp.alloc(0, 3) == tp.alloc(0, 3) == [0, 1, 2]
    before = tp.refs.copy(), tp.counters()
    with pytest.raises(tkv.PagePoolExhausted, match="need 2 pages, 1 free"):
        tp.alloc(0, 2)
    with pytest.raises(jkv.PagePoolExhausted, match="need 2 pages, 1 free"):
        jp.alloc(0, 2)
    np.testing.assert_array_equal(tp.refs, before[0])
    assert tp.counters() == before[1] == jp.counters()
    assert tp.telemetry() == jp.telemetry()
    assert tp.trash == jp.trash == 4
    tp.release(0, [1])
    with pytest.raises(ValueError, match="double free"):
        tp.release(0, [1])
    with pytest.raises(ValueError, match="retain of free"):
        tp.retain(0, [1])
    # LIFO: the page freed last is handed out first
    assert tp.alloc(0, 1) == [1]
