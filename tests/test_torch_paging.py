"""paddle_tpu_torch.serving.paging against the JAX package's, script by
script.

The host-side page bookkeeping (PagePool, PageTable, PrefixCache,
chain_keys) is copied from the JAX package; the same scripts, driven by
the same seeds, must leave both packages in the same state: the same
pages handed out in the same order, the same refcounts and free lists,
the same prefix matches and evictions. save_pages / restore_pages read
and write torch pools in place here (numpy in the JAX package's tests):
the same churn must give the same page ids and the same bytes.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import paging as jpaging
from paddle_tpu_torch.serving import paging as tpaging


def _state(pool):
    return (list(pool._free), list(pool._ref), pool.pages_in_use,
            pool.pages_free)


def _churn(paging, seed, steps=2000):
    """tests/test_paged.py's churn script; returns the state trace."""
    rng = np.random.RandomState(seed)
    pool = paging.PagePool(17, 4)
    held, trace = [], []
    for _ in range(steps):
        r = rng.rand()
        if r < 0.45:
            try:
                held.append(pool.alloc())
            except paging.CacheExhaustedError:
                assert pool.pages_free == 0
                trace.append('exhausted')
        elif r < 0.80 and held:
            pool.unref(held.pop(rng.randint(len(held))))
        elif held:
            held.append(pool.share(held[rng.randint(len(held))]))
        pool.check()
        trace.append(_state(pool))
    for p in held:
        pool.unref(p)
    pool.check()
    trace.append(_state(pool))
    return pool, trace


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_random_churn_matches_jax(seed):
    tpool, ttrace = _churn(tpaging, seed)
    _, jtrace = _churn(jpaging, seed)
    assert ttrace == jtrace
    assert tpool.pages_in_use == 0 and tpool.pages_free == 16
    with pytest.raises(ValueError, match='double free'):
        tpool.unref(1)
    with pytest.raises(ValueError, match='null page'):
        tpool.unref(0)


def test_alloc_many_all_or_nothing_matches_jax():
    out = []
    for paging in (tpaging, jpaging):
        pool = paging.PagePool(5, 4)
        got = pool.alloc_many(3)
        with pytest.raises(paging.CacheExhaustedError) as ei:
            pool.alloc_many(2)
        assert ei.value.retryable
        pool.check()
        out.append((got, _state(pool)))
    assert out[0] == out[1]
    assert out[0][1][3] == 1              # the failed batch took nothing


def _cow_script(paging):
    pool = paging.PagePool(9, 4)
    parent = paging.PageTable(pool, 2)
    parent.ensure(6)
    parent.length = 6
    before = list(parent.pages)
    child = paging.PageTable(pool, 2)
    child.adopt_shared(list(parent.pages), 6)
    src, dst = child.cow_for_append(6)
    assert parent.pages == before           # the parent is untouched
    rec = [before, list(child.pages), (src, dst), pool.refcount(src),
           sorted(child.shared)]
    pool.unref(src)                         # after the device copy ran
    pool.check()
    child.release()
    parent.release()
    pool.check()
    rec.append(_state(pool))
    return rec


def test_cow_never_mutates_parent_matches_jax():
    rec = _cow_script(tpaging)
    assert rec == _cow_script(jpaging)
    before, child_pages, (src, dst), ref, _ = rec[:5]
    assert src == before[1] and dst not in before
    assert child_pages == [before[0], dst]
    assert ref == 2                         # the deferred unref
    assert rec[-1][2] == 0


def _prefix_script(paging):
    pool = paging.PagePool(17, 4)
    table = paging.PageTable(pool, 4)
    prompt = list(range(10))                # 2 full pages + a 2-token tail
    table.ensure(10)
    table.length = 10
    cache = paging.PrefixCache(pool)
    rec = [cache.register(prompt, table), len(cache)]
    rec.append(cache.match(prompt, limit=9))
    rec.append(cache.match(prompt + [99, 98], limit=11))
    rec.append(cache.match([5] + prompt, limit=10))
    rec.append((cache.hits, cache.misses, cache.tokens_reused))
    for _ in range(3):
        rec.append((cache.evict_one(), len(cache), _state(pool)))
        pool.check()
    rec.append(cache.evict_one())
    rec.append(cache.drain_events())
    table.release()
    pool.check()
    rec.append(_state(pool))
    return rec


def test_prefix_cache_register_match_evict_matches_jax():
    rec = _prefix_script(tpaging)
    assert rec == _prefix_script(jpaging)
    assert rec[0] == [0, 1, 2] and rec[1] == 3
    assert rec[2][1] == 8 and rec[3][1] == 10
    assert rec[5] == (2, 1, 18)
    assert [r[1] for r in rec[6:9]] == [2, 1, 0]   # leaf-first LRU
    assert rec[9] is False
    assert rec[-1][2] == 0


@pytest.mark.parametrize('limit', [None, 9, 12])
def test_chain_keys_match_jax(limit):
    toks = list(np.random.RandomState(3).randint(1, 64, 13))
    assert tpaging.chain_keys(toks, 4, limit=limit) == \
        jpaging.chain_keys(toks, 4, limit=limit)


def _swap_churn(paging, make_pool, read):
    """tests/test_preempt.py's save/restore churn with one backing
    pool; returns the page-id trace and the final pool bytes."""
    rng = np.random.RandomState(23)
    pool = paging.PagePool(17, 4)
    arr = make_pool(rng.rand(17, 4, 2, 2).astype('f4'))
    held, swapped, trace = [], [], []
    for _ in range(800):
        r = rng.rand()
        if r < 0.40:
            try:
                p = pool.alloc()
            except paging.CacheExhaustedError:
                assert pool.pages_free == 0
            else:
                arr[p] = make_pool(rng.rand(4, 2, 2).astype('f4'))
                held.append(p)
        elif r < 0.60 and held:
            k = int(rng.randint(1, min(3, len(held)) + 1))
            ids = [held.pop(int(rng.randint(len(held)))) for _ in range(k)]
            data = pool.save_pages([arr], ids)
            assert np.array_equal(data[0], read(arr)[np.asarray(ids)])
            for p in ids:
                pool.unref(p)
            swapped.append(data)
            trace.append(('save', ids))
        elif r < 0.80 and swapped:
            data = swapped.pop(int(rng.randint(len(swapped))))
            try:
                ids, (out,) = pool.restore_pages([arr], data)
            except paging.CacheExhaustedError:
                swapped.append(data)
                trace.append('exhausted')
            else:
                assert out is arr or isinstance(arr, np.ndarray)
                assert np.array_equal(read(arr)[np.asarray(ids)], data[0])
                held.extend(ids)
                trace.append(('restore', ids))
        elif held:
            pool.unref(held.pop(int(rng.randint(len(held)))))
        pool.check()
    for p in held:
        pool.unref(p)
    for data in swapped:
        ids, _ = pool.restore_pages([arr], data)
        trace.append(('restore', ids))
        for p in ids:
            pool.unref(p)
    pool.check()
    return trace, read(arr), pool


def test_save_restore_churn_matches_jax_in_place():
    ttrace, tbytes, tpool = _swap_churn(
        tpaging, torch.from_numpy, lambda a: a.numpy())
    jtrace, jbytes, _ = _swap_churn(jpaging, np.asarray, np.asarray)
    assert ttrace == jtrace
    assert np.array_equal(tbytes, jbytes)
    assert tpool.pages_in_use == 0
    # a freed or null page is a caller bug, not a silent gather
    pool = torch.zeros(17, 4, 2, 2)
    with pytest.raises(ValueError, match='dead/null'):
        tpool.save_pages([pool], [0])
    with pytest.raises(ValueError, match='dead/null'):
        tpool.save_pages([pool], [3])


def test_restore_pages_writes_the_same_storage():
    pool = tpaging.PagePool(9, 4)
    dev = torch.zeros(9, 4, 2, 2)
    ptr = dev.data_ptr()
    ids = pool.alloc_many(2)
    dev[torch.tensor(ids)] = torch.rand(2, 4, 2, 2)
    saved = pool.save_pages([dev], ids)
    for p in ids:
        pool.unref(p)
    new, (out,) = pool.restore_pages([dev], saved)
    assert out is dev and dev.data_ptr() == ptr
    assert np.array_equal(dev[torch.tensor(new)].numpy(), saved[0])
