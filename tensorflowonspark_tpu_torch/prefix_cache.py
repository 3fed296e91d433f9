"""Host-side page allocator for the paged KV layout (the port's own copy
of ``PagePool`` from the JAX package's ``prefix_cache.py``).

Only the allocator is ported so far.  The radix ``PrefixCache`` and the
disaggregated-handoff leases wait for later slices (ROADMAP queue A).
"""

import numpy as np


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
    """

    def __init__(self, num_pages, reserved=1):
        if int(num_pages) <= int(reserved):
            raise ValueError(
                "num_pages ({0}) must exceed the {1} reserved "
                "page(s)".format(num_pages, reserved)
            )
        self.num_pages = int(num_pages)
        self.reserved = int(reserved)
        self._refs = np.zeros((self.num_pages,), np.int64)
        # LIFO free list: recently freed pages are handed out first
        self._free = list(range(self.num_pages - 1, self.reserved - 1, -1))

    def available(self):
        return len(self._free)

    def alloc(self, n):
        """``n`` free page indices at refcount 1."""
        n = int(n)
        if n > len(self._free):
            raise PoolExhausted(
                "page pool exhausted: need {0} pages, {1} free of "
                "{2}".format(n, len(self._free), self.num_pages)
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

    def stats(self):
        return {
            "pool_pages": self.num_pages,
            "pool_pages_free": len(self._free),
            "pool_pages_used": self.num_pages - self.reserved - len(self._free),
            # pages referenced by two or more holders
            "pool_pages_shared": int((self._refs >= 2).sum()),
        }
