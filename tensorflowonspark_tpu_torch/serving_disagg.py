"""Disaggregated prefill: the prefill half of a split serving engine
(port of the JAX package's ``serving_disagg.py``).

Prefill is one compute-bound pass over a whole prompt; decode is a long
run of small bandwidth-bound steps.  :class:`PrefillWorker` runs the
prefill as a program of its own, and the chunked
:class:`~.models.transformer.SlotDecoder` stays the decode scheduler.
The KV crosses between them as a block-table exchange over the
decoder's shared page pool:

1. the worker allocates a page row from the decoder's
   :class:`~.prefix_cache.PagePool` (cached radix prefix pages go in as
   indices, as in a unified paged admit) and tags it in flight under a
   handoff lease (``begin_handoff``);
2. its prefill writes the prompt's KV straight into those pool pages
   through a one-row block table and samples the first token;
3. :meth:`SlotDecoder.adopt` puts the row into the target slot's table
   (host bookkeeping) and writes the slot's ``[num_slots]`` state
   entries: no KV is copied, the pages the prefill wrote are the pages
   decode reads (the pools' storage and versions untouched,
   ``pool_pages_handoff`` back at 0).

The worker shares the decoder's pool, radix cache, generator and
sampling knobs, so a disaggregated engine serves the tokens of the
unified one.  In this port both halves run on the decoder's device and
its current CUDA stream, one after the other.
"""

import numpy as np

__all__ = [
    "Handoff", "PrefillAbandoned", "PrefillWorker", "PrefillWorkerDead",
]


class PrefillWorkerDead(RuntimeError):
    """The worker is gone (its device failed, or a chaos ``kill_prefill``
    fault fired).  The engine reaps the orphaned handoff lease,
    re-prefills the stranded request through the unified path and
    rebuilds the worker (``ServingEngine.restart_prefill_worker``)."""


class PrefillAbandoned(RuntimeError):
    """Raised inside a wedged prefill that wakes to find its watchdog has
    abandoned it: it must not touch the pools, the generator or its
    (already reaped) lease pages, so it stops before the forward."""


class Handoff(object):
    """One finished prefill, ready for :meth:`SlotDecoder.adopt`.

    ``pages`` is the page row holding the prompt's KV (the adopting
    slot's whole table span), ``n_tokens`` the prompt length,
    ``cached_tokens`` the radix-cached prefix depth, ``first`` the
    sampled first token (an unsynchronised device scalar, as
    :meth:`SlotDecoder.admit` returns it); ``owner``/``lease`` name the
    pool lease holding the pages in flight.
    """

    __slots__ = (
        "pages", "n_tokens", "cached_tokens", "first", "owner", "lease",
    )

    def __init__(self, pages, n_tokens, cached_tokens, first,
                 owner=None, lease=None):
        self.pages = list(pages)
        self.n_tokens = int(n_tokens)
        self.cached_tokens = int(cached_tokens)
        self.first = first
        self.owner = owner
        self.lease = lease


class PrefillWorker(object):
    """The prefill side of a disaggregated engine over a paged
    :class:`SlotDecoder`: the canonical-position suffix prefill writing
    through a one-row block table into the decoder's pools (the paged
    admit without the slot-state writes, which moved to ``adopt``).

    ``fault_fn(prefill_index, worker)`` is the chaos hook (default: the
    plan's :func:`..testing.chaos.prefill_fault_fn`), called with the
    lease open; ``lease_deadline_sec`` stamps the worker's leases.
    """

    def __init__(self, decoder, fault_fn=None, lease_deadline_sec=None):
        if not getattr(decoder, "_paged", False):
            raise ValueError(
                "PrefillWorker needs a paged SlotDecoder "
                "(kv_layout='paged'): the prefill→decode handoff is a "
                "block-table exchange over the shared page pool"
            )
        if getattr(decoder, "_spec", False):
            raise ValueError(
                "disaggregated prefill does not compose with "
                "draft-model speculation (the draft's contiguous banks "
                "live on the decode side only)"
            )
        self.decoder = decoder
        #: forwards of the last prefill(): always 1 (cached pages go in
        #: as indices, the commit records indices)
        self.last_prefill_dispatches = 0
        #: set by a ``kill_prefill`` fault (or a supervisor that saw the
        #: worker's device fail): prefill() refuses until the engine
        #: rebuilds the worker
        self.dead = False
        #: deadline stamped on this worker's handoff leases (None: reaped
        #: by owner only)
        self.lease_deadline_sec = lease_deadline_sec
        #: prefill() entries so far: the chaos fault index
        self._prefills = 0
        if fault_fn is None:
            from tensorflowonspark_tpu_torch.testing import chaos

            fault_fn = chaos.prefill_fault_fn()
        self._fault = fault_fn

    def prefill(self, prompt, owner=None, abandoned_fn=None,
                new_tokens=None):
        """Prefill one prompt and return its :class:`Handoff`.

        The unified paged admit's pool and radix protocol
        (:meth:`SlotDecoder._prefill_row`), with the row under a handoff
        lease and without the slot-state writes.  ``owner`` (the request's trace
        id) is stamped on the pool lease; ``abandoned_fn`` is the
        supervised dispatch's flag: a wedged prefill that wakes after its
        watchdog gave up raises :class:`PrefillAbandoned` before it draws
        from the generator or writes a pool, which keeps the unified
        re-prefill token-identical to a run without the fault.
        ``new_tokens`` is :meth:`SlotDecoder.admit`'s: the tokens still
        to generate (default ``max_new_tokens``), for a request requeued
        with its committed tokens appended.
        """
        if self.dead:
            raise PrefillWorkerDead(
                "prefill worker is dead; the engine must rebuild it "
                "(restart_prefill_worker) before serving prefills"
            )
        dec = self.decoder
        prompt = np.asarray(prompt, np.int32).ravel()
        n = int(prompt.shape[0])
        if n == 0:
            raise ValueError("cannot prefill an empty prompt")
        need = dec.max_new_tokens if new_tokens is None else int(new_tokens)
        if n + need > dec.cache_len:
            raise ValueError(
                "prompt ({0}) + max_new_tokens ({1}) exceeds the "
                "engine cache_len={2}".format(n, need, dec.cache_len)
            )
        pool = dec.page_pool
        leases = []

        def open_lease(row):
            leases.append(pool.begin_handoff(
                row, owner=owner, deadline_sec=self.lease_deadline_sec))
            self._prefills += 1
            if self._fault is not None:
                # the chaos gate: the lease is open, the pools and the
                # generator untouched, as at a real death mid-handoff
                self._fault(self._prefills - 1, self)
            if self.dead:
                raise PrefillWorkerDead(
                    "prefill worker died mid-handoff (owner={0}, lease "
                    "#{1}, {2} pages in flight)".format(owner, leases[0],
                                                        len(row))
                )
            if abandoned_fn is not None and abandoned_fn():
                raise PrefillAbandoned(
                    "prefill dispatch abandoned by its watchdog "
                    "(owner={0}, lease #{1})".format(owner, leases[0])
                )

        def check_abandoned():
            if abandoned_fn is not None and abandoned_fn():
                # abandoned during the forward: the reaper owns the
                # lease's pages now, so nothing may be committed from
                # this thread
                raise PrefillAbandoned(
                    "prefill dispatch abandoned mid-program "
                    "(owner={0}, lease #{1})".format(owner, leases[0])
                )

        self.last_prefill_dispatches = 1
        row, kpref, first = dec._prefill_row(
            prompt, n, on_row=open_lease, on_forward=check_abandoned)
        return Handoff(row, n, kpref, first, owner=owner, lease=leases[0])

    def abandon(self, handoff):
        """Release an un-adopted handoff's pages (its admit failed, or
        the request expired between prefill and adopt): the abandon path
        of the protocol, so that a failed adopt never leaks pool
        pages."""
        pool = self.decoder.page_pool
        pool.end_handoff(handoff.pages)
        pool.release(handoff.pages)
        handoff.pages = []
