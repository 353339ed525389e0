"""Paged KV cache + shared-prefix (radix) reuse: the memory layer of
the serving tier, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/serve/pages.py``.

* **Device** (torch): one pool of ``num_pages`` pages per K/V leaf,
  ``[L, num_pages, page_size, kv_heads, head_dim]`` (int8 under
  ``kv_cache_dtype="int8"``, beside f32 ``k_scale``/``v_scale`` planes
  ``[L, num_pages, page_size, kv_heads, 1]``), plus the per-slot
  LOGICAL column state (``start_col``/``write_col``/``positions``).
  Page 0 is the reserved TRASH page: retired rows' frozen writes and
  prefill pad columns land there, and no validity mask ever admits its
  cells.
* **Host** (plain Python and numpy, copied from the JAX package so the
  port imports none of it): ``PagePool`` keeps the free list, per-page
  refcounts and the radix prefix tree under one lock; a per-slot PAGE
  TABLE row maps logical columns to pool pages.

**Radix prefix cache.**  Prompts are keyed by ``page_size``-token
chunks: a tree node per FULL chunk, holding the pool page with that
chunk's K/V.  A request whose prompt starts with cached chunks maps
those pages read-only (refcount++) and starts its chunked prefill at
``pos = skip``.  At admission the request's own full prompt pages are
registered back into the tree.  Only FULL chunks are shared, so a shared
page is never written again; a prompt exactly equal to a cached chain
re-prefills its last page into a private copy (the COW split,
``cow_splits_total``).  Eviction is LRU over refcount-0 LEAF nodes;
``PagePoolExhausted`` means every remaining page is pinned.

The pool also keeps a bounded digest of its hot chains (chain hash ->
cached tokens, ``fingerprint``), updated where the tree changes.

Namespaces: K/V depend on the LoRA adapter a request decodes under (its
k and v deltas), so the tree has one root per namespace (``b""`` for no
adapter; the scheduler passes an adapter's content digest) and a chain
never crosses namespaces.  A namespace's chain hashes start from its own
root hash, so shipped pages are matched within their namespace too.
(The JAX package keeps one tree for all adapters.)

Migration: an exported request's lease is handed off (``handoff``): its
final full pages are published into the tree before the lease is
released, so a re-import here skips those windows, and the page wire
reads them back by chain (``chain_pages``).
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["FINGERPRINT_K", "PageLease", "PagePool", "PagePoolExhausted",
           "auto_page_size", "decode_paged_step", "init_paged_cache",
           "paged_kv_valid", "prompt_chain_keys"]

# default bound on the hot-chain fingerprint (entries, not pages)
FINGERPRINT_K = 32


def _chain_hash(parent_chain: bytes, chunk: bytes) -> bytes:
    """One incremental step of the chain hash: H(parent || chunk).
    blake2b-64: process-stable (placement must replay across runs,
    unlike ``hash()``), 8 bytes because fingerprint keys are a
    popularity digest, not a cryptographic commitment."""
    return hashlib.blake2b(parent_chain + chunk, digest_size=8).digest()


def _root_chain(namespace: bytes) -> bytes:
    """The chain hash a namespace's root starts from (``b""`` for the
    default namespace, so its keys are the JAX package's)."""
    return _chain_hash(b"", b"namespace:" + namespace) if namespace else b""


def prompt_chain_keys(prompt, page_size: int, namespace: bytes = b""
                      ) -> Tuple[Tuple[bytes, int], ...]:
    """The request-side half of the prefix fingerprint: ``(chain hash,
    tokens covered)`` for every full ``page_size``-token chunk prefix
    of ``prompt`` under ``namespace`` — exactly the keys
    ``PagePool.register`` publishes, so ``fingerprint.get(key)`` answers
    "how many of this prompt's leading tokens does that replica already
    hold"."""
    pg = int(page_size)
    if pg < 1:
        return ()
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    out = []
    chain = _root_chain(namespace)
    for j in range(prompt.size // pg):
        chain = _chain_hash(chain, prompt[j * pg:(j + 1) * pg].tobytes())
        out.append((chain, (j + 1) * pg))
    return tuple(out)


class PagePoolExhausted(RuntimeError):
    """``allocate`` could not find enough free/evictable pages: every
    remaining page is pinned by an in-flight request.  Backpressure,
    not failure — the scheduler requeues and retries after a
    retirement frees pages."""


def auto_page_size(max_len: int, target: int = 16) -> int:
    """Largest divisor of ``max_len`` that is <= ``target``.  Pages
    must tile ``max_len`` exactly, so every row's page view is
    ``max_len`` columns.  The port's paged-attention kernel takes any
    page size (it gathers per column), so there is no further rule."""
    for d in range(min(target, max_len), 0, -1):
        if max_len % d == 0:
            return d
    return 1


def init_paged_cache(model, num_slots: int, num_pages: int,
                     page_size: int):
    """Device state for a paged slot cache on the model's device: the
    page-pool K/V leaves ``[L, num_pages, page_size, kv_heads,
    head_dim]`` in the model dtype, or under ``kv_cache_dtype="int8"``
    int8 leaves and the f32 ``k_scale``/``v_scale`` planes ``[...,
    kv_heads, 1]`` (all zero: an unwritten cell dequantizes to 0), plus
    per-slot int32 column state (``start_col``/``write_col``/``positions``
    stay LOGICAL columns)."""
    c = model.config
    dev = model.device
    shape = (c.num_layers, num_pages, page_size, c.kv_heads, c.head_dim)
    if c.kv_cache_dtype == "int8":
        sshape = shape[:-1] + (1,)
        kv = {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
              "v": torch.zeros(shape, dtype=torch.int8, device=dev),
              "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                     device=dev),
              "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                     device=dev)}
    else:
        kv = {"k": torch.zeros(shape, dtype=c.dtype, device=dev),
              "v": torch.zeros(shape, dtype=c.dtype, device=dev)}

    def col():
        return torch.zeros((num_slots,), dtype=torch.int32, device=dev)
    return {"kv": kv, "start_col": col(), "write_col": col(),
            "positions": col()}


def paged_kv_valid(cache, view_len: int) -> torch.Tensor:
    """[S, view_len] bool: each slot's valid LOGICAL columns."""
    cols = torch.arange(view_len, dtype=torch.int32,
                        device=cache["write_col"].device)[None, :]
    return ((cols >= cache["start_col"][:, None])
            & (cols < cache["write_col"][:, None]))


def decode_paged_step(model, cache, page_tab: torch.Tensor,
                      tokens: torch.Tensor, live: torch.Tensor,
                      adapters=None,
                      adapter_rows: Optional[torch.Tensor] = None):
    """One decode step for every slot against the page pool -> (logits
    [S, vocab], new cache).  ``page_tab`` [S, pages_per_slot] int32 is
    this tick's page-table snapshot (retired rows map the trash page);
    ``live`` [S] bool advances only live rows' column state;
    ``adapters``/``adapter_rows`` [S]: per-slot LoRA adapters (None: no
    adapter work).  The pool is written in place."""
    page_size = cache["kv"]["k"].shape[2]
    view_len = page_tab.shape[1] * page_size
    logits, kv = model.decode_step_slots_paged(
        cache["kv"], tokens, page_tab, cache["write_col"],
        paged_kv_valid(cache, view_len), cache["positions"],
        adapters=adapters, adapter_rows=adapter_rows)
    live = live.to(torch.int32)
    return logits, {
        "kv": kv,
        "start_col": cache["start_col"],
        "write_col": cache["write_col"] + live,
        "positions": cache["positions"] + live,
    }


class _RadixNode:
    """One FULL prompt chunk: the pool page holding its K/V, its place
    in the tree, a refcount (in-flight requests mapping it), and an
    LRU stamp (monotonic counter, not wall clock — eviction order must
    replay deterministically)."""

    __slots__ = ("page", "parent", "children", "refcount", "stamp",
                 "key", "chain")

    def __init__(self, page: int, parent: Optional["_RadixNode"],
                 key: bytes, stamp: int):
        self.page = page
        self.parent = parent
        self.children: Dict[bytes, "_RadixNode"] = {}
        self.refcount = 0
        self.stamp = stamp
        self.key = key
        # incremental chain hash from the root — the fingerprint key
        # for "the prefix ending at this node", paid once at node
        # creation instead of on every fingerprint update
        self.chain = (_chain_hash(parent.chain, key)
                      if parent is not None else b"")


class PageLease:
    """One request's page holdings: the page-table row it decodes
    through, which of those pages are shared radix nodes vs private,
    and how many logical columns the row maps.  Created by
    ``PagePool.begin`` at prefill start, registered into the radix tree
    at admission, released (idempotently) at retirement/cancel."""

    __slots__ = ("row", "n_pages", "skip", "shared", "private",
                 "released", "namespace")

    def __init__(self, row: np.ndarray, n_pages: int, skip: int,
                 shared: List[_RadixNode], private: List[int],
                 namespace: bytes = b""):
        self.row = row                   # [pages_per_slot] int32
        self.n_pages = n_pages           # mapped entries (shared+private)
        self.skip = skip                 # prefix tokens mapped shared
        self.shared = shared             # radix nodes we hold a ref on
        self.private = private           # pool pages we own outright
        self.released = False
        self.namespace = namespace       # the tree it matched and publishes


class PagePool:
    """Host bookkeeping for the device page pool: free list, refcounts,
    and the radix prefix tree.  All methods are thread-safe behind the
    pool's own lock and never invoke callbacks or block under it."""

    def __init__(self, num_pages: int, page_size: int,
                 pages_per_slot: int, prefix_cache: bool = True,
                 fingerprint_k: int = FINGERPRINT_K):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1; got {page_size}")
        if fingerprint_k < 0:
            raise ValueError(
                f"fingerprint_k must be >= 0; got {fingerprint_k}")
        if num_pages < pages_per_slot + 2:
            # one trash page + at least one full slot's worth: anything
            # smaller cannot serve even a single max-length request
            raise ValueError(
                f"num_pages must be >= pages_per_slot + 2 = "
                f"{pages_per_slot + 2}; got {num_pages}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        # prefix_cache=False: paged allocation only, no radix matching
        # or registration
        self.prefix_cache = bool(prefix_cache)
        self.fingerprint_k = int(fingerprint_k)
        # hot-chain digest: chain hash -> (cached tokens, recency
        # stamp), bounded to fingerprint_k entries (see module doc)
        self._fingerprint: Dict[bytes, Tuple[int, int]] = {}
        self._lock = threading.Lock()
        # page 0 is the reserved trash page — never allocated
        self._free: List[int] = list(range(1, num_pages))
        self._root = _RadixNode(0, None, b"", 0)
        # namespace -> root (the default namespace's is ``_root``)
        self._roots: Dict[bytes, _RadixNode] = {b"": self._root}
        self._stamp = 0
        # live-lease accounting for the pages_per_request gauge
        self._lease_count = 0
        self._lease_pages = 0
        # counters (read through stats())
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.evictions = 0
        self.cow_splits = 0

    # ------------------------------------------------------------ intake

    def required_pages(self, total_cols: int) -> int:
        """Pages a request writing ``total_cols`` logical columns needs
        in the worst (no shared prefix) case."""
        return -(-int(total_cols) // self.page_size)

    def usable_pages(self) -> int:
        """Pool capacity minus the reserved trash page — the submit
        validation bound: one request may never need more."""
        return self.num_pages - 1

    def _root_locked(self, namespace: bytes) -> _RadixNode:
        root = self._roots.get(namespace)
        if root is None:
            root = self._roots[namespace] = _RadixNode(0, None, b"", 0)
            root.chain = _root_chain(namespace)
        return root

    def begin(self, prompt: np.ndarray, total_cols: int,
              namespace: bytes = b"") -> PageLease:
        """Start one request: match its prompt against the radix tree
        (full ``page_size`` chunks only, always leaving at least one
        token to prefill so the last window can produce logits), pin
        the matched chain, allocate private pages for the rest, and
        return the lease with its page-table row.

        ``total_cols``: columns the request will ever write (prompt +
        decode budget); ``namespace``: the tree to match in (and that
        ``register`` publishes to).  Raises ``PagePoolExhausted`` — with every
        acquired ref rolled back — when not enough pages are free or
        evictable."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = prompt.size
        pg = self.page_size
        total = self.required_pages(max(total_cols, plen))
        if total > self.pages_per_slot:
            raise ValueError(
                f"request spans {total} pages > pages_per_slot "
                f"{self.pages_per_slot}")
        with self._lock:
            self.prefix_lookups += 1
            shared: List[_RadixNode] = []
            node = self._root_locked(namespace)
            chunks = plen // pg if self.prefix_cache else 0
            for j in range(chunks):
                child = node.children.get(
                    prompt[j * pg:(j + 1) * pg].tobytes())
                if child is None:
                    break
                shared.append(child)
                node = child
            if len(shared) * pg >= plen:
                # the whole prompt is a cached chain, but its last page
                # must take this request's decode writes: split it off
                # as a fresh private copy, re-prefilled rather than
                # device-copied (bit-identical — same tokens, same
                # executable).  This is the COW case.
                shared.pop()
                self.cow_splits += 1
            skip = len(shared) * pg
            stamp = self._next_stamp()
            for n in shared:
                n.refcount += 1
                n.stamp = stamp
            try:
                private = self._allocate_locked(total - len(shared))
            except PagePoolExhausted:
                for n in shared:          # roll back the pins
                    n.refcount -= 1
                raise
            if skip:
                self.prefix_hits += 1
                self.prefix_tokens_reused += skip
            for j, n in enumerate(shared):
                # refresh the hit chain's fingerprint recency at every
                # depth — the list we just walked, never a tree walk
                self._fp_touch_locked(n.chain, (j + 1) * pg, stamp)
            row = np.zeros((self.pages_per_slot,), np.int32)
            for j, n in enumerate(shared):
                row[j] = n.page
            row[len(shared):total] = private
            lease = PageLease(row, total, skip, shared, private, namespace)
            self._lease_count += 1
            self._lease_pages += total
            return lease

    def register(self, lease: PageLease, prompt: np.ndarray) -> None:
        """Publish the lease's FULL prompt pages into the radix tree
        (called at admission, when their contents are final).  Pages
        donated to the tree move from the lease's private list to its
        shared refs; on a chunk another request registered first, stop
        — ours stay private (rare race, costs one duplicate page until
        retirement)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pg = self.page_size
        if not self.prefix_cache:
            return
        with self._lock:
            if lease.released:
                return               # cancelled before admission landed
            node = self._root_locked(lease.namespace)
            stamp = self._next_stamp()
            for j in range(prompt.size // pg):
                key = prompt[j * pg:(j + 1) * pg].tobytes()
                child = node.children.get(key)
                if child is not None:
                    child.stamp = stamp
                    node = child
                    self._fp_touch_locked(child.chain, (j + 1) * pg,
                                          stamp)
                    continue
                page = int(lease.row[j])
                if page not in lease.private:
                    break            # a shared entry we did not match??
                child = _RadixNode(page, node, key, stamp)
                child.refcount = 1   # the lease's own pin
                node.children[key] = child
                lease.private.remove(page)
                lease.shared.append(child)
                node = child
                # publish EVERY depth, not just the deepest: the
                # deepest node carries this prompt's unique suffix,
                # while followers match at the shared shallow depths
                self._fp_touch_locked(child.chain, (j + 1) * pg, stamp)


    def handoff(self, lease: PageLease, context: np.ndarray) -> int:
        """Export-path lease handoff: publish the lease's FINAL full-chunk
        pages for ``context`` (the request's context plus the generated
        tokens whose K/V are written; the caller truncates it to the
        columns the device has finished) into the radix tree, then
        release the lease.  A re-import into this engine then matches the
        chain and re-prefills only the unpublished tail.  Returns the
        pages published (0 with the prefix cache off, where this is a
        plain release)."""
        published = 0
        if self.prefix_cache and not lease.released:
            before = len(lease.shared)
            self.register(lease, context)
            published = len(lease.shared) - before
        self.release(lease)
        return published

    def chain_pages(self, context: np.ndarray,
                    namespace: bytes = b"") -> list:
        """The radix chain covering ``context``'s full chunks in
        ``namespace``:
        ``[(chunk_index, page, chain_hash)]`` down the tree, stopping at
        the first unmatched chunk.  The page wire's sender-side lookup:
        the caller reads the pages while holding the scheduler's pump
        lock, which also serialises every eviction (they run inside
        ``begin``), so the pages cannot be recycled under the read.
        Empty with the prefix cache off."""
        if not self.prefix_cache:
            return []
        context = np.asarray(context, np.int32).reshape(-1)
        pg = self.page_size
        out = []
        with self._lock:
            node = self._roots.get(namespace)
            for j in range(context.size // pg if node else 0):
                child = node.children.get(
                    context[j * pg:(j + 1) * pg].tobytes())
                if child is None:
                    break
                out.append((j, int(child.page), child.chain))
                node = child
        return out

    def release(self, lease: PageLease) -> None:
        """Return a lease's holdings: shared pins drop (the chain stays
        cached, evictable once refcount-0), private pages go straight
        back to the free list.  Idempotent — cancel racing retirement
        must not double-free."""
        with self._lock:
            if lease.released:
                return
            lease.released = True
            stamp = self._next_stamp()
            for n in lease.shared:
                n.refcount -= 1
                n.stamp = stamp
            self._free.extend(lease.private)
            self._lease_count -= 1
            self._lease_pages -= lease.n_pages

    # ----------------------------------------------------- alloc / evict

    def _next_stamp(self) -> int:
        self._stamp += 1
        return self._stamp

    def _allocate_locked(self, n: int) -> List[int]:
        while len(self._free) < n and self._evict_one_locked():
            pass
        if len(self._free) < n:
            raise PagePoolExhausted(
                f"need {n} pages, {len(self._free)} free and no "
                "unpinned prefix chains left to evict")
        pages, self._free = self._free[:n], self._free[n:]
        return pages

    def _evict_one_locked(self) -> bool:
        """Evict the least-recently-used refcount-0 LEAF node (chains
        evict tail-first, so an interior page is never freed while a
        descendant still chains through it; pinned nodes are
        untouchable)."""
        best: Optional[_RadixNode] = None
        stack = [n for root in self._roots.values()
                 for n in root.children.values()]
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif node.refcount == 0 and (best is None
                                         or node.stamp < best.stamp):
                best = node
        if best is None:
            return False
        del best.parent.children[best.key]
        if best.parent.parent is None and not best.parent.children \
                and best.parent is not self._root:
            # an emptied namespace root holds no page: drop it
            self._roots = {ns: r for ns, r in self._roots.items()
                           if r is not best.parent}
        self._free.append(best.page)
        self._fingerprint.pop(best.chain, None)
        self.evictions += 1
        return True

    # ------------------------------------------------------- fingerprint

    def _fp_touch_locked(self, key: bytes, tokens: int,
                         stamp: int) -> None:
        """Upsert one chain into the bounded fingerprint; on overflow
        drop the entry with the lowest cached-length × recency score
        (ties: older stamp, then key bytes — fully deterministic)."""
        if not self.fingerprint_k:
            return
        fp = self._fingerprint
        fp[key] = (tokens, stamp)
        if len(fp) > self.fingerprint_k:
            drop = min(fp.items(),
                       key=lambda kv: (kv[1][0] * kv[1][1], kv[1][1],
                                       kv[0]))[0]
            del fp[drop]

    def fingerprint(self) -> Dict[bytes, int]:
        """Copy of the hot-chain digest: chain hash -> cached tokens.
        Lock-cheap (<= fingerprint_k small entries); this is the map
        a prefix-affinity router scores placement against."""
        with self._lock:
            return {k: v[0] for k, v in self._fingerprint.items()}

    # ------------------------------------------------------------- stats

    def stats(self) -> Dict[str, float]:
        """Counter/gauge snapshot for ``EngineStats`` (the ONE
        bookkeeping source the serve gauges render from)."""
        with self._lock:
            per_req = (self._lease_pages / self._lease_count
                       if self._lease_count else 0.0)
            return {
                "pages_total": self.num_pages - 1,
                "pages_free": len(self._free),
                "pages_per_request": per_req,
                "prefix_lookups_total": self.prefix_lookups,
                "prefix_hits_total": self.prefix_hits,
                "prefix_tokens_reused_total": self.prefix_tokens_reused,
                "prefix_evictions_total": self.evictions,
                "cow_splits_total": self.cow_splits,
                "page_size": self.page_size,
                "prefix_fingerprint": {
                    k: v[0] for k, v in self._fingerprint.items()},
            }
