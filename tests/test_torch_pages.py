"""The port's PagePool (host half of serve/pages.py): the unit tests of
tests/test_pages.py, run against the port's copy."""
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.models.gpt import GPT, gpt_tiny
from distributed_tensorflow_tpu_torch.serve import pages as pages_lib

torch.set_num_threads(1)


def _radix_pages(pool):
    n, max_ref = 0, 0
    stack = list(pool._root.children.values())
    while stack:
        node = stack.pop()
        n += 1
        max_ref = max(max_ref, node.refcount)
        stack.extend(node.children.values())
    return n, max_ref


def test_auto_page_size_divides_max_len():
    assert pages_lib.auto_page_size(256) == 16
    assert pages_lib.auto_page_size(40) == 10
    assert pages_lib.auto_page_size(16) == 16
    assert pages_lib.auto_page_size(7) == 7
    assert pages_lib.auto_page_size(31) == 1
    for n in (16, 24, 40, 256, 31, 1024):
        assert n % pages_lib.auto_page_size(n) == 0


def test_init_paged_cache_shapes_and_valid_window():
    model = GPT(gpt_tiny(num_heads=4, num_kv_heads=2), device="cpu")
    c = model.config
    cache = pages_lib.init_paged_cache(model, num_slots=3, num_pages=9,
                                       page_size=8)
    assert cache["kv"]["k"].shape == (c.num_layers, 9, 8, c.kv_heads,
                                      c.head_dim)
    assert cache["kv"]["k"].dtype == torch.float32
    assert cache["write_col"].shape == (3,)
    assert cache["write_col"].dtype == torch.int32
    cache["start_col"][1] = 2
    cache["write_col"][1] = 5
    valid = pages_lib.paged_kv_valid(cache, 8)
    assert valid[1].tolist() == [False, False, True, True, True, False,
                                 False, False]
    assert not valid[0].any()


def test_pool_validation():
    with pytest.raises(ValueError, match="num_pages"):
        pages_lib.PagePool(num_pages=4, page_size=8, pages_per_slot=4)
    with pytest.raises(ValueError, match="page_size"):
        pages_lib.PagePool(num_pages=8, page_size=0, pages_per_slot=2)


def test_pool_match_register_release_refcounts():
    pool = pages_lib.PagePool(num_pages=17, page_size=4, pages_per_slot=4)
    prompt = np.arange(10, dtype=np.int32)        # 2 full chunks + 2
    a = pool.begin(prompt, 12)
    assert a.skip == 0 and a.n_pages == 3 and len(a.private) == 3
    pool.register(a, prompt)
    assert len(a.private) == 1 and len(a.shared) == 2
    cached, max_ref = _radix_pages(pool)
    assert cached == 2 and max_ref == 1
    b = pool.begin(prompt, 12)
    assert b.skip == 8 and len(b.shared) == 2 and len(b.private) == 1
    assert _radix_pages(pool)[1] == 2
    assert pool.stats()["prefix_hits_total"] == 1
    assert pool.stats()["prefix_tokens_reused_total"] == 8
    pool.release(a)
    pool.release(a)                               # idempotent
    assert _radix_pages(pool)[1] == 1
    pool.release(b)
    cached, max_ref = _radix_pages(pool)
    assert cached == 2 and max_ref == 0
    st = pool.stats()
    assert st["pages_free"] + cached == st["pages_total"]


def test_pool_eviction_lru_and_pinning():
    pool = pages_lib.PagePool(num_pages=7, page_size=4, pages_per_slot=4)
    p1 = np.arange(4, dtype=np.int32)
    p2 = np.arange(4, 8, dtype=np.int32)
    for p in (p1, p2):
        lease = pool.begin(p, 5)
        pool.register(lease, p)
        pool.release(lease)
    assert pool.stats()["pages_free"] == 4
    held = pool.begin(np.concatenate([p2, np.arange(90, 94,
                                                    dtype=np.int32)]), 9)
    assert held.skip == 4 and len(held.shared) == 1
    big = pool.begin(np.arange(100, 112, dtype=np.int32), 12)
    assert pool.stats()["prefix_evictions_total"] == 1
    pool.release(big)
    probe = pool.begin(np.concatenate([p2, p2]), 9)
    assert probe.skip == 4                        # p2's page survived
    pool.release(probe)
    miss = pool.begin(np.concatenate([p1, p1]), 9)
    assert miss.skip == 0                         # p1's chain was evicted
    pool.release(miss)
    pool.release(held)
    cached, max_ref = _radix_pages(pool)
    assert max_ref == 0
    assert pool.stats()["pages_free"] + cached == 6


def test_pool_exhausted_rolls_back_pins():
    pool = pages_lib.PagePool(num_pages=7, page_size=4, pages_per_slot=4)
    p = np.arange(8, dtype=np.int32)
    a = pool.begin(p, 9)
    pool.register(a, p)
    c = pool.begin(np.arange(50, 58, dtype=np.int32), 12)
    assert pool.stats()["pages_free"] == 0
    with pytest.raises(pages_lib.PagePoolExhausted):
        pool.begin(np.concatenate([p, np.arange(60, 64, dtype=np.int32)]),
                   16)
    assert _radix_pages(pool)[1] == 1
    assert pool.stats()["pages_free"] == 0
    pool.release(a)
    pool.release(c)
    cached, _ = _radix_pages(pool)
    assert pool.stats()["pages_free"] + cached == 6


def test_cow_split_and_fingerprint():
    pool = pages_lib.PagePool(num_pages=9, page_size=4, pages_per_slot=4)
    p = np.arange(8, dtype=np.int32)
    a = pool.begin(p, 10)
    pool.register(a, p)
    b = pool.begin(p, 10)                         # whole chain cached
    assert b.skip == 4 and pool.stats()["cow_splits_total"] == 1
    keys = pages_lib.prompt_chain_keys(p, 4)
    assert [t for _, t in keys] == [4, 8]
    assert pool.fingerprint() == {k: t for k, t in keys}
    pool.release(a)
    pool.release(b)


def test_pool_namespaces_keep_chains_apart():
    """A chain registered in one namespace (an adapter's) is matched only
    there; its chain keys differ from the default namespace's, whose keys
    stay the JAX package's; an emptied namespace is dropped."""
    pool = pages_lib.PagePool(num_pages=9, page_size=4, pages_per_slot=4)
    prompt = np.arange(9, dtype=np.int32)
    a = pool.begin(prompt, 10, namespace=b"adapter-a")
    pool.register(a, prompt)
    pool.release(a)
    miss = pool.begin(prompt, 10)                           # default ns
    assert miss.skip == 0
    pool.release(miss)
    hit = pool.begin(prompt, 10, namespace=b"adapter-a")
    assert hit.skip == 8 and hit.namespace == b"adapter-a"
    keys = pages_lib.prompt_chain_keys(prompt, 4, b"adapter-a")
    assert [t for _, t in keys] == [4, 8]
    assert keys[0][0] != pages_lib.prompt_chain_keys(prompt, 4)[0][0]
    assert [c for _, _, c in pool.chain_pages(prompt, b"adapter-a")] \
        == [k for k, _ in keys]
    assert pool.chain_pages(prompt) == []
    pool.release(hit)
    # pool pressure evicts the namespace's chain and drops its root
    for lo in (50, 70):
        pool.begin(np.arange(lo, lo + 12, dtype=np.int32), 16)
    assert pool.stats()["prefix_evictions_total"] == 2
    assert set(pool._roots) == {b""}
