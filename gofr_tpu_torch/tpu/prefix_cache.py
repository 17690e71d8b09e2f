"""Device-resident prefix KV store for the generate engine (counterpart
of ``gofr_tpu/tpu/prefix_cache.py``).

Serving traffic shares prompt heads (system prompts, few-shot
templates). The store keeps their KV: a host trie over *page-aligned*
prompt token ids maps each page (a run of ``page`` tokens) to one page
of a :class:`~gofr_tpu_torch.tpu.page_pool.PagePool`, so a later prompt
with the same head prefills only its suffix (``llama.prefill(prefix=,
prefix_len=)``).

- **Page pool**: owned by the store on the dense engine (the trie is its
  only client), or the paged engine's own pool (``pool=``), where a
  prefix hit is a page-table entry and not a copy.
- **Trie (host)**: one node per page, keyed by its token tuple; a chain
  from the root spells a cached prefix. Lookups never touch the device.
- **References**: ``node.refs`` pins a node against eviction while a
  slot reads it (dense: one admission pass; paged: the slot's life,
  since decode reads the page every tick). Each node holds one pool
  reference on its page, dropped at eviction, so a page adopted from a
  slot (:meth:`register`) outlives the slot.
- **LRU eviction** of *leaves* with no pins: interior nodes go only
  after their children, so every surviving chain stays walkable. It is
  also the pool's ``reclaim`` hook.
- **Over a mesh** (``mesh=``, the dense engine's): the owned pool is
  sharded on kv heads over ``tp`` and replicated over the other axes
  (``tpu/page_pool``); :meth:`PrefixStore.gather` reads the tp ranks'
  pages of the first replica, :meth:`PrefixStore.publish` writes each
  rank's rows into every replica. The trie is one for all shards.
- **Publish in place** (dense engine): JAX publishes into a fresh pool
  array so that suffix prefills dispatched earlier keep reading the old
  one. Here the pool's leaves are written in place, which is safe
  because every read and write of them (suffix prefills and inserts,
  publishes) is queued from the engine's one device thread onto one
  stream, in dispatch order: a page evicted and republished by a later
  admission is written only after every earlier read of it ran. The
  paged engine publishes nothing: a full prefill writes its pages in
  place and :meth:`register` adopts their ids.

Determinism: with a bf16 cache the pages hold exactly the K/V a full
prefill computes, and the suffix rows get a full prefill's bits through
the flash kernel (``llama.prefill``) and the engine's minimum of prefill
rows on the card, so greedy tokens are the same with the store on or
off. With ``cfg.kv_int8`` the pages hold the quantised rows and the
suffix prefill dequantises them: its logits drift by the quantisation.
"""

from __future__ import annotations

import hashlib
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from gofr_tpu_torch.tpu.page_pool import PagePool

__all__ = ["PrefixStore", "chain_hashes"]


def _chain_hash(parent: bytes, key: Sequence[int]) -> bytes:
    """One link of the page-chain hash: H(parent digest || page tokens),
    so an entry names the page's whole prefix."""
    h = hashlib.blake2b(parent, digest_size=8)
    h.update(b"".join(int(t).to_bytes(4, "little", signed=True)
                      for t in key))
    return h.digest()


def chain_hashes(tokens: Sequence[int], page: int,
                 max_pages: int = 64) -> List[str]:
    """Chained page-prefix hashes of a prompt's head: ``out[i]`` names
    ``tokens[:(i + 1) * page]``. Full pages only. A fleet router matches
    them against replicas' :meth:`PrefixStore.digest`."""
    out: List[str] = []
    parent = b""
    for i in range(min(len(tokens) // page, max_pages)):
        parent = _chain_hash(parent, tokens[i * page:(i + 1) * page])
        out.append(parent.hex())
    return out


class _PageNode:
    """One cached page: ``key`` its token tuple, ``page_id`` its pool
    page; ``refs`` pins it against eviction while a slot reads it."""

    __slots__ = ("key", "parent", "children", "page_id", "refs",
                 "last_used")

    def __init__(self, key: Tuple[int, ...], parent: Optional["_PageNode"],
                 page_id: int):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_PageNode"] = {}
        self.page_id = page_id
        self.refs = 0
        self.last_used = 0


class PrefixStore:
    """Host trie over a device page pool. ``page`` tokens a page;
    ``budget_bytes`` sizes an owned pool (``num_pages`` overrides it);
    ``max_pages`` caps a cached prefix's pages. ``pool=`` indexes the
    engine's pool instead of owning one."""

    def __init__(self, cfg, page: int = 32, budget_bytes: int = 64 << 20,
                 max_pages: int = 0, num_pages: Optional[int] = None,
                 pool: Optional[PagePool] = None,
                 device: Union[str, torch.device] = "cuda", mesh=None):
        self.cfg = cfg
        self.max_pages = int(max_pages)
        self.budget_bytes = int(budget_bytes)
        if pool is not None:
            if pool.page != int(page):
                raise ValueError(
                    f"prefix page ({page}) must equal the shared pool's "
                    f"page ({pool.page})")
            self.owns_pool = False
            self._pool = pool
        else:
            self.owns_pool = True
            self._pool = PagePool(cfg, page=page, num_pages=num_pages,
                                  budget_bytes=self.budget_bytes,
                                  device=device, mesh=mesh)
        self.page = self._pool.page
        self.page_bytes = self._pool.page_bytes
        # cumulative counters: they survive reset()
        self.hits = 0
        self.partial_hits = 0
        self.misses = 0
        self.tokens_saved = 0
        self.inserts = 0
        self.adoptions = 0
        self.evictions = 0
        self.publishes = 0
        self._clock = 0
        self._root = _PageNode((), None, -1)
        self._nodes: List[_PageNode] = []
        self.reset()

    @staticmethod
    def _page_bytes(cfg, page: int) -> int:
        """Device bytes one page occupies across every cache leaf."""
        return PagePool._page_bytes(cfg, page)

    @property
    def num_pages(self) -> int:
        return self._pool.num_pages

    @num_pages.setter
    def num_pages(self, n: int) -> None:
        # takes effect at the next reset() (tests shrink owned pools)
        self._pool.num_pages = int(n)

    @property
    def pool(self) -> Dict[str, torch.Tensor]:
        """The pool's leaves, (L, num_pages + 1, page, ...): what suffix
        prefills gather from."""
        return self._pool.leaves

    def reset(self) -> None:
        """Drop every cached prefix; an owned pool is cleared too. With a
        shared pool the engine resets the pool (it holds the other
        references)."""
        self._root = _PageNode((), None, -1)
        self._nodes = []
        if self.owns_pool:
            self._pool.reset()

    # -- host index ---------------------------------------------------------
    def _touch(self, node: _PageNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    def max_lookup_pages(self, prompt_len: int) -> int:
        """Pages a prompt of this length may reuse: full pages, leaving
        the suffix at least one token to sample the first token from."""
        return min(max(0, (prompt_len - 1) // self.page), self.max_pages)

    def lookup(self, tokens: Sequence[int]) -> List[_PageNode]:
        """Longest cached page chain matching the prompt's head; bumps the
        chain's LRU clock."""
        chain: List[_PageNode] = []
        node = self._root
        for i in range(self.max_lookup_pages(len(tokens))):
            child = node.children.get(
                tuple(tokens[i * self.page:(i + 1) * self.page]))
            if child is None:
                break
            self._touch(child)
            chain.append(child)
            node = child
        return chain

    def classify(self, matched: int, requestable: int) -> str:
        """Count one lookup: ``hit`` (the whole requestable prefix was
        cached), ``partial`` (some) or ``miss`` (none)."""
        if matched <= 0:
            self.misses += 1
            return "miss"
        if matched >= requestable:
            self.hits += 1
            return "hit"
        self.partial_hits += 1
        return "partial"

    def record_saved(self, tokens: int) -> None:
        """Prompt tokens whose prefill reuse skipped."""
        self.tokens_saved += tokens

    def acquire(self, nodes: Sequence[_PageNode]) -> None:
        for node in nodes:
            node.refs += 1

    def release(self, nodes: Sequence[_PageNode]) -> None:
        for node in nodes:
            node.refs = max(0, node.refs - 1)

    def evict_one(self) -> bool:
        """Evict the least recently used unpinned leaf, dropping its pool
        reference. False when every node is pinned or the trie is empty;
        never blocks (the pool's ``reclaim`` hook)."""
        victim: Optional[_PageNode] = None
        for node in self._nodes:
            if node.children or node.refs > 0:
                continue
            if victim is None or node.last_used < victim.last_used:
                victim = node
        if victim is None:
            return False
        del victim.parent.children[victim.key]
        self._nodes.remove(victim)
        self.evictions += 1
        self._pool.release([victim.page_id])
        return True

    def insert(self, tokens: Sequence[int],
               want_pages: int) -> List[Tuple[int, bool]]:
        """Walk or create the chain of the prompt's first ``want_pages``
        pages: ``(page_id, is_new)`` a page, where an old page already
        holds its K/V. Stops early when no page can be had (everything
        pinned and the pool full)."""
        out: List[Tuple[int, bool]] = []
        node = self._root
        for i in range(min(want_pages, self.max_pages)):
            key = tuple(tokens[i * self.page:(i + 1) * self.page])
            child = node.children.get(key)
            if child is None:
                ids = self._pool.alloc(1, reclaim=self.evict_one)
                if ids is None:
                    break
                child = _PageNode(key, node, ids[0])
                node.children[key] = child
                self._nodes.append(child)
                self.inserts += 1
                out.append((ids[0], True))
            else:
                out.append((child.page_id, False))
            self._touch(child)
            node = child
        return out

    def register(self, tokens: Sequence[int],
                 page_ids: Sequence[int]) -> List[_PageNode]:
        """Adopt pages a slot's prefill wrote (``page_ids[i]`` holds the
        K/V of ``tokens[i * page:(i + 1) * page]``) without a copy: the
        trie takes one pool reference on each new one. A page whose chain
        is cached already is skipped (the slot keeps its own copy, with
        the same K/V). Returns the chain walked."""
        chain: List[_PageNode] = []
        node = self._root
        for i in range(min(len(page_ids), self.max_pages)):
            key = tuple(tokens[i * self.page:(i + 1) * self.page])
            child = node.children.get(key)
            if child is None:
                pid = int(page_ids[i])
                self._pool.retain([pid])
                child = _PageNode(key, node, pid)
                node.children[key] = child
                self._nodes.append(child)
                self.inserts += 1
                self.adoptions += 1
            self._touch(child)
            chain.append(child)
            node = child
        return chain

    # -- device side (dense engine) -----------------------------------------
    def gather(self, page_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The prefix K/V of ``page_ids`` (nb, p) pages a row, leaf by
        leaf (L, nb, p * page, ...): what a suffix prefill and its insert
        read. Over a mesh, the tp ranks' (a list, rank r's kv heads)."""
        nb, p = page_ids.shape

        def rows(leaves):
            return {name: leaf[:, page_ids].reshape(
                        leaf.shape[0], nb, p * self.page, *leaf.shape[3:])
                    for name, leaf in leaves.items()}
        if self._pool.mesh is None:
            return rows(self._pool.leaves)
        return [rows(leaves) for leaves in self._pool.ranks()]

    def publish(self, small: Dict[str, torch.Tensor], flat_ids: torch.Tensor,
                n_pages: int) -> None:
        """Write freshly prefilled pages into the pool, in place: the
        first ``n_pages`` pages of each row of ``small`` (L, nb, lb, ...)
        go to ``flat_ids`` (nb * n_pages,) on the device, where the
        sentinel (pages cached already, short prompts, padding rows)
        lands in the pool's scratch page. Called on the engine's device
        thread, behind every earlier read of the pool, inside a prefill's
        graph on the card: the engine counts ``publishes`` on the host,
        one for each group with a page to publish (JAX's count). Over a
        mesh ``small`` is the tp ranks' (a list), each rank's rows
        written into every replica."""
        smalls = [small] if isinstance(small, dict) else small
        for replica in self._pool.replicas():
            for leaves, rank_small in zip(replica, smalls):
                for name, leaf in leaves.items():
                    rows = rank_small[name]
                    nb = rows.shape[1]
                    leaf[:, flat_ids] = rows[
                        :, :, :n_pages * self.page].reshape(
                        rows.shape[0], nb * n_pages, self.page,
                        *rows.shape[3:])

    # -- introspection ------------------------------------------------------
    @property
    def used_pages(self) -> int:
        """Pages the trie holds (on a shared pool, a subset of the pool's
        used pages)."""
        return len(self._nodes)

    def digest(self, max_entries: int = 512) -> Dict[str, Any]:
        """The resident trie as chained page hashes (as
        :func:`chain_hashes` makes them), breadth first, so a truncated
        digest drops only the deepest chains; plus occupancy."""
        entries: List[str] = []
        queue: "deque[Tuple[_PageNode, bytes]]" = deque(
            (child, b"") for child in self._root.children.values())
        while queue and len(entries) < max_entries:
            node, parent = queue.popleft()
            digest = _chain_hash(parent, node.key)
            entries.append(digest.hex())
            for child in node.children.values():
                queue.append((child, digest))
        return {
            "page": self.page,
            "entries": entries,
            "truncated": bool(queue),
            "used_pages": self.used_pages,
            "num_pages": self.num_pages,
            "occupancy": (round(self.used_pages / self.num_pages, 6)
                          if self.num_pages else 0.0),
        }

    def stats(self) -> Dict[str, Any]:
        lookups = self.hits + self.partial_hits + self.misses
        return {
            "page_tokens": self.page,
            "num_pages": self.num_pages,
            "used_pages": self.used_pages,
            "max_pages_per_prefix": self.max_pages,
            "budget_bytes": self.budget_bytes,
            "page_bytes": self.page_bytes,
            "pool_bytes": self.num_pages * self.page_bytes,
            "shared_pool": not self.owns_pool,
            "occupancy": (round(self.used_pages / self.num_pages, 6)
                          if self.num_pages else 0.0),
            "lookups": {"total": lookups, "hit": self.hits,
                        "partial": self.partial_hits, "miss": self.misses},
            "tokens_saved": self.tokens_saved,
            "inserts": self.inserts,
            "adoptions": self.adoptions,
            "evictions": self.evictions,
            "publishes": self.publishes,
        }
