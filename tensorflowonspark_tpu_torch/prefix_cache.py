"""The radix prefix cache and the page allocator for cross-request KV
reuse (port of the JAX package's ``prefix_cache.py``).

:class:`PrefixCache` is a radix tree over token prefixes in blocks of
``block_tokens`` tokens: every node is one block, keyed by its token
content, and owns that block's committed KV (a payload this module never
looks into).  An admit whose prompt extends a cached prefix reuses the
cached blocks and prefills only the uncached suffix
(``models.transformer.SlotDecoder``).  Cached keys are post-RoPE, so a
block is reusable only at the positions it was written at: blocks are
stored, and cached admits placed, at canonical positions (token ``i`` at
cache position ``i``).

- A lookup pins its matched path (:meth:`PrefixCache.acquire` returns a
  :class:`Lease`) until the admit has used it; eviction removes only cold
  leaves (no children, no pins), least recently used first, so a shared
  interior block outlives every prompt family built on it.
- Every block's bytes count against ``mem_budget_bytes``: inserts evict
  cold leaves to stay under it, and the serving engine's ``degrade``
  policy calls :meth:`PrefixCache.evict_cold` under backlog pressure.

Payloads are per-block KV copies on the contiguous layout and physical
page indices of a :class:`PagePool` on the paged layout, where
``release_fn``/``on_insert`` keep the pool's refcounts in step with the
nodes' lives.  All bookkeeping is on the host.

The pool's handoff leases serve the disaggregated engine
(:mod:`..serving_disagg`): a prefill worker tags the page row it wrote
as in flight (:meth:`PagePool.begin_handoff`, with an owner and a
deadline) until the decoder adopts it (:meth:`PagePool.end_handoff`);
:meth:`PagePool.reap_orphans` reclaims the leases of a worker that died
or wedged, one reference per page.

The cache's counters have registry twins (``prefix_cache.hits``,
``misses``, ``tokens_saved``, ``evictions``, the ``bytes_used`` gauge).
"""

import hashlib
import itertools
import logging
import time

import numpy as np

logger = logging.getLogger(__name__)


class PoolExhausted(RuntimeError):
    """The page pool has no free pages left."""


class PagePool(object):
    """Refcounted allocator over a fixed set of physical KV pages.

    The device pools are preallocated ``[num_pages, page_tokens, heads,
    dim]`` tensors; this class only tracks indices into them.

    - :meth:`alloc` hands out ``n`` free pages at refcount 1.
    - :meth:`retain` adds a reference; :meth:`release` drops one, and a
      page returns to the free list only at refcount 0.

    The ``reserved`` leading pages (page 0 by default) are never handed
    out: idle slots' block tables point at them, so dead-lane decode
    writes land in a trash page instead of a live one.

    ``clock`` (default ``time.monotonic``) stamps handoff leases; tests
    pass a fake one to age them.
    """

    def __init__(self, num_pages, reserved=1, clock=None):
        if int(num_pages) <= int(reserved):
            raise ValueError(
                "num_pages ({0}) must exceed the {1} reserved "
                "page(s)".format(num_pages, reserved)
            )
        self.num_pages = int(num_pages)
        self.reserved = int(reserved)
        self._clock = clock if clock is not None else time.monotonic
        self._refs = np.zeros((self.num_pages,), np.int64)
        # LIFO free list: recently freed pages are handed out first
        self._free = list(range(self.num_pages - 1, self.reserved - 1, -1))
        # pages a disaggregated prefill wrote and no slot adopted yet (the
        # refcounts keep them alive; this set makes them observable)
        self._handoff = set()
        # lease id -> {"owner", "pages" (set), "t0", "deadline_sec"}
        self._leases = {}
        self._lease_seq = itertools.count(1)

    def available(self):
        return len(self._free)

    def alloc(self, n):
        """``n`` free page indices at refcount 1."""
        n = int(n)
        if n > len(self._free):
            raise PoolExhausted(
                "page pool exhausted: need {0} pages, {1} free of "
                "{2} ({3})".format(n, len(self._free), self.num_pages,
                                   self.lease_table())
            )
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def retain(self, pages):
        for p in pages:
            if self._refs[p] <= 0:
                raise ValueError("retain() on free page {0}".format(int(p)))
            self._refs[p] += 1

    def release(self, pages):
        for p in pages:
            if self._refs[p] <= 0:
                raise ValueError("release() on free page {0}".format(int(p)))
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(int(p))

    def refcount(self, page):
        return int(self._refs[page])

    def refcount_census(self):
        """``{page: refcount}`` over every live page.  A quiesced paged
        decoder (no slot in flight) must census to exactly its radix
        cache's committed pages (:meth:`PrefixCache.page_census`) at
        refcount 1 each; the reserved trash page never appears."""
        return {int(p): int(self._refs[p])
                for p in np.nonzero(self._refs)[0]}

    # -- handoff leases (serving_disagg) ---------------------------------

    def begin_handoff(self, pages, owner=None, deadline_sec=None):
        """Tag live ``pages`` as in flight between a prefill worker and
        the decoder, under a new lease (returned): ``owner`` names the
        holder (the request's trace id), ``deadline_sec`` how long it may
        stay in flight before :meth:`reap_orphans` takes it as orphaned
        (None: reaped by owner only)."""
        pages = [int(p) for p in pages]
        for p in pages:
            if self._refs[p] <= 0:
                raise ValueError("begin_handoff() on free page {0} "
                                 "({1})".format(p, self.lease_table()))
        self._handoff.update(pages)
        lease = next(self._lease_seq)
        self._leases[lease] = {
            "owner": owner, "pages": set(pages), "t0": self._clock(),
            "deadline_sec": (None if deadline_sec is None
                             else float(deadline_sec)),
        }
        return lease

    def end_handoff(self, pages):
        """Clear the in-flight tag of ``pages`` (adopted into a slot's
        table, or abandoned and released); a lease whose pages have all
        ended is settled and removed."""
        pages = {int(p) for p in pages}
        self._handoff -= pages
        for lease in [k for k, rec in self._leases.items()
                      if rec["pages"] & pages]:
            rec = self._leases[lease]
            rec["pages"] -= pages
            if not rec["pages"]:
                del self._leases[lease]

    def handoff_leases(self, now=None):
        """The live leases, oldest first, as dicts of ``lease``,
        ``owner``, ``age_sec``, ``pages`` (a count), ``deadline_sec`` and
        ``expired``."""
        now = self._clock() if now is None else float(now)
        out = []
        for lease, rec in sorted(self._leases.items(),
                                 key=lambda kv: kv[1]["t0"]):
            age = max(0.0, now - rec["t0"])
            dl = rec["deadline_sec"]
            out.append({"lease": lease, "owner": rec["owner"],
                        "age_sec": age, "pages": len(rec["pages"]),
                        "deadline_sec": dl,
                        "expired": dl is not None and age > dl})
        return out

    def lease_table(self, now=None):
        """One line naming every live lease (owner, pages, age), for
        pool-exhaustion and handoff errors."""
        rows = self.handoff_leases(now=now)
        if not rows:
            return "no handoff leases"
        return "leases: " + "; ".join(
            "#{0} owner={1} pages={2} age={3:.1f}s{4}".format(
                r["lease"], r["owner"] or "?", r["pages"], r["age_sec"],
                " EXPIRED" if r["expired"] else "")
            for r in rows)

    def reap_orphans(self, owner=None, now=None):
        """Reclaim orphaned leases: every lease of ``owner`` when given,
        else every lease past its deadline.  Each reaped lease clears its
        pages' in-flight tag and releases exactly one reference per page
        (what :meth:`..serving_disagg.PrefillWorker.abandon` does: a
        worker's handoff holds one reference to each page of its row).
        Returns the reaped leases' summaries."""
        now = self._clock() if now is None else float(now)
        reaped = []
        for lease in list(self._leases):
            rec = self._leases[lease]
            age = max(0.0, now - rec["t0"])
            dl = rec["deadline_sec"]
            if owner is not None:
                if rec["owner"] != owner:
                    continue
            elif dl is None or age <= dl:
                continue
            pages = sorted(rec["pages"])
            del self._leases[lease]
            self._handoff.difference_update(pages)
            self.release(pages)
            reaped.append({"lease": lease, "owner": rec["owner"],
                           "age_sec": age, "pages": len(pages)})
            logger.warning("page pool reaped orphaned handoff lease #%d "
                           "(owner=%s, %d pages, age %.1fs)", lease,
                           rec["owner"], len(pages), age)
        return reaped

    def stats(self):
        return {
            "pool_pages": self.num_pages,
            "pool_pages_free": len(self._free),
            "pool_pages_used": self.num_pages - self.reserved - len(self._free),
            # pages referenced by two or more holders
            "pool_pages_shared": int((self._refs >= 2).sum()),
            # pages in flight between a prefill worker and the decoder,
            # and the leases holding them
            "pool_pages_handoff": len(self._handoff),
            "pool_leases": len(self._leases),
        }


class _Node(object):
    """One cached block: ``key`` (its tokens), its KV ``payload``, and
    the radix links and bookkeeping."""

    __slots__ = ("key", "parent", "children", "payload", "nbytes",
                 "refs", "last_used")

    def __init__(self, key, parent, payload, nbytes):
        self.key = key
        self.parent = parent
        self.children = {}
        self.payload = payload
        self.nbytes = int(nbytes)
        self.refs = 0
        self.last_used = 0


class Lease(object):
    """A pinned lookup: the matched path (root-most first) and the tokens
    it covers.  Hold it while the admit reads the payloads, then
    :meth:`PrefixCache.release` it."""

    __slots__ = ("nodes", "n_tokens")

    def __init__(self, nodes, n_tokens):
        self.nodes = nodes
        self.n_tokens = int(n_tokens)

    @property
    def n_blocks(self):
        return len(self.nodes)

    def payloads(self):
        return [n.payload for n in self.nodes]


def _block_key(tokens):
    """Content key of one block of tokens (int32 bytes, so int32 and
    int64 prompts index the same node)."""
    return np.asarray(tokens, np.int32).tobytes()


def pages_for_tokens(n_tokens, page_tokens):
    """Pages a ``n_tokens``-token context occupies at ``page_tokens``
    tokens a page (ceiling division; 0 for an empty context)."""
    n, p = int(n_tokens), max(1, int(page_tokens))
    return (n + p - 1) // p


#: Width in tokens of a prompt's affinity fingerprint: a module constant,
#: not a cache's geometry, so caches of different ``block_tokens`` agree
#: on what "same prefix" means
FINGERPRINT_TOKENS = 16


def fingerprint(tokens, width=FINGERPRINT_TOKENS):
    """Stable 64-bit fingerprint of the prompt's leading ``width`` tokens
    (all of a shorter prompt), over :func:`_block_key`'s bytes: two
    prompts share it iff they share those tokens."""
    tokens = np.asarray(tokens, np.int32).ravel()
    key = _block_key(tokens[:max(1, int(width))])
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(),
                          "big")


class PrefixCache(object):
    """Radix index over token prefixes -> committed KV blocks.

    Args:
      block_tokens: tokens a block (the radix edge width).
      mem_budget_bytes: budget of the cached payloads; inserts evict cold
        leaves to stay under it, and an insert that cannot fit (every
        block pinned) is dropped and counted in ``insert_drops``.
      clock: LRU tick source (tests); default a counter.
      release_fn: called with a node's payload when the node is evicted
        (the paged layout releases the page's pool reference there).
    """

    def __init__(self, block_tokens=16, mem_budget_bytes=256 << 20,
                 clock=None, release_fn=None):
        if int(block_tokens) < 1:
            raise ValueError(
                "block_tokens must be >= 1, got {0}".format(block_tokens)
            )
        self.block_tokens = int(block_tokens)
        self.mem_budget_bytes = int(mem_budget_bytes)
        self._release_fn = release_fn
        self._clock = (clock if clock is not None
                       else itertools.count(1).__next__)
        self._root = _Node(None, None, None, 0)
        self.bytes_used = 0
        self.n_nodes = 0
        # cumulative counters (the serving engine reports per-job deltas)
        self.hits = 0          # lookups that matched at least one block
        self.misses = 0        # lookups that matched nothing
        self.tokens_saved = 0  # prompt tokens not prefilled again
        self.evictions = 0     # blocks evicted (budget or pressure)
        self.insert_drops = 0  # inserts dropped: the budget is all pinned
        # registry twins of the counters (null metrics when disabled)
        from tensorflowonspark_tpu_torch import telemetry

        reg = telemetry.get_registry()
        self._m_hits = reg.counter("prefix_cache.hits")
        self._m_misses = reg.counter("prefix_cache.misses")
        self._m_tokens_saved = reg.counter("prefix_cache.tokens_saved")
        self._m_evictions = reg.counter("prefix_cache.evictions")
        self._m_bytes = reg.gauge("prefix_cache.bytes_used")

    # -- lookup / pin ---------------------------------------------------

    def match_blocks(self, tokens, limit_tokens=None):
        """The longest cached path of whole blocks prefixing ``tokens``
        (within ``limit_tokens``), not pinned; root-most first."""
        tokens = np.asarray(tokens, np.int32).ravel()
        n = tokens.shape[0] if limit_tokens is None else min(
            tokens.shape[0], int(limit_tokens))
        b = self.block_tokens
        nodes = []
        cur = self._root
        for i in range(n // b):
            child = cur.children.get(_block_key(tokens[i * b:(i + 1) * b]))
            if child is None:
                break
            nodes.append(child)
            cur = child
        return nodes

    def acquire(self, tokens, limit_tokens=None):
        """Look up the longest cached prefix of ``tokens`` and pin it.
        Returns a :class:`Lease` (``n_tokens == 0`` on a miss).  The
        decoder passes ``limit_tokens=len(prompt) - 1`` so that at least
        one token is left to prefill for the first-token logits."""
        nodes = self.match_blocks(tokens, limit_tokens)
        now = self._clock()
        for node in nodes:
            node.refs += 1
            node.last_used = now
        matched = len(nodes) * self.block_tokens
        if nodes:
            self.hits += 1
            self.tokens_saved += matched
            self._m_hits.inc()
            self._m_tokens_saved.inc(matched)
        else:
            self.misses += 1
            self._m_misses.inc()
        return Lease(nodes, matched)

    def release(self, lease):
        """Unpin a :class:`Lease`; a lease releases exactly once."""
        if lease.nodes is None:
            raise ValueError("lease already released")
        for node in lease.nodes:
            if node.refs <= 0:
                raise ValueError("release() without matching acquire()")
            node.refs -= 1
        lease.nodes = None

    # -- insert / evict -------------------------------------------------

    def insert(self, tokens, payloads, first_block, nbytes_per_block,
               on_insert=None):
        """Attach ``payloads`` as blocks ``first_block..`` of the
        ``tokens`` path; the first ``first_block`` blocks must be cached
        already (the lookup's match).  Returns the number of blocks newly
        inserted: an existing node stays (the payloads are the same KV).
        ``on_insert`` is called with each payload the tree takes
        (skipped and dropped ones stay the caller's)."""
        tokens = np.asarray(tokens, np.int32).ravel()
        b = self.block_tokens
        cur = self._root
        for i in range(int(first_block)):
            cur = cur.children[_block_key(tokens[i * b:(i + 1) * b])]
        inserted = 0
        for j, payload in enumerate(payloads):
            i = int(first_block) + j
            key = _block_key(tokens[i * b:(i + 1) * b])
            child = cur.children.get(key)
            if child is None:
                # the node this block extends is a leaf until the block
                # lands: pinned, so that making room never evicts it (the
                # new block would hang off a detached node, and a paged
                # payload not yet retained would free a slot's page)
                cur.refs += 1
                try:
                    fits = self._make_room(int(nbytes_per_block))
                finally:
                    cur.refs -= 1
                if not fits:
                    self.insert_drops += 1
                    break
                child = _Node(key, cur, payload, nbytes_per_block)
                child.last_used = self._clock()
                cur.children[key] = child
                self.bytes_used += child.nbytes
                self.n_nodes += 1
                inserted += 1
                self._m_bytes.set(self.bytes_used)
                if on_insert is not None:
                    on_insert(payload)
            cur = child
        return inserted

    def _make_room(self, nbytes):
        """Evict cold leaves until ``nbytes`` more fit the budget; False
        when they cannot."""
        if nbytes > self.mem_budget_bytes:
            return False
        while self.bytes_used + nbytes > self.mem_budget_bytes:
            if not self._evict_one():
                return False
        return True

    def _cold_leaves(self):
        out = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self._root and not node.children \
                    and node.refs == 0:
                out.append(node)
        return out

    def _evict_one(self):
        leaves = self._cold_leaves()
        if not leaves:
            return False
        victim = min(leaves, key=lambda n: n.last_used)
        del victim.parent.children[victim.key]
        victim.parent = None
        if self._release_fn is not None:
            self._release_fn(victim.payload)
        victim.payload = None
        self.bytes_used -= victim.nbytes
        self.n_nodes -= 1
        self.evictions += 1
        self._m_evictions.inc()
        self._m_bytes.set(self.bytes_used)
        return True

    def evict_blocks(self, n=1):
        """Evict up to ``n`` cold leaf blocks (LRU first); returns how
        many went.  The paged decoder calls this under pool pressure."""
        done = 0
        for _ in range(int(n)):
            if not self._evict_one():
                break
            done += 1
        return done

    def evict_cold(self, target_bytes):
        """Evict cold leaf blocks (LRU first) until ``bytes_used <=
        target_bytes``; returns the number evicted."""
        n = 0
        while self.bytes_used > max(0, int(target_bytes)):
            if not self._evict_one():
                break
            n += 1
        return n

    def clear(self):
        """Drop every unpinned block."""
        return self.evict_cold(0)

    # -- introspection --------------------------------------------------

    def fingerprint(self, tokens, width=None):
        """:func:`fingerprint` at :data:`FINGERPRINT_TOKENS` (not this
        cache's ``block_tokens``) unless ``width`` is given."""
        return fingerprint(tokens,
                           FINGERPRINT_TOKENS if width is None else width)

    def page_census(self):
        """Sorted payloads of every committed block: on the paged layout
        the pool pages the radix holds one reference to each."""
        out, stack = [], [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self._root and node.payload is not None:
                out.append(node.payload)
        try:
            return sorted(int(p) for p in out)
        except (TypeError, ValueError):
            return out  # contiguous layout: payloads are KV copies

    def stats(self):
        return {
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_tokens_saved": self.tokens_saved,
            "evictions": self.evictions,
            "insert_drops": self.insert_drops,
            "bytes_used": self.bytes_used,
            "nodes": self.n_nodes,
        }

    def __len__(self):
        return self.n_nodes
