"""Shared retry policy: exponential backoff + jitter + hard deadline
(copy of the JAX package's ``utils/retry.py``).

- **exponential backoff**: attempt ``i`` sleeps ``base * factor**i``
  capped at ``max_delay``;
- **full jitter**: each sleep is drawn uniformly from ``[delay/2,
  delay]`` so a fleet of clients desynchronizes instead of stampeding;
- **hard deadline**: the loop exhausts on elapsed time, measured on
  ``time.monotonic()`` (injectable as ``clock=``), not attempt count,
  and the final error names what was being retried.
"""

import logging
import random
import time

logger = logging.getLogger(__name__)


class RetryError(Exception):
    """Raised when a retried call exhausts its deadline.  ``last`` holds
    the final underlying exception (also chained via ``__cause__``)."""

    def __init__(self, message, last=None):
        super(RetryError, self).__init__(message)
        self.last = last


class Backoff(object):
    """Iterator of jittered exponential delays under a deadline.

    Usage::

        for attempt in Backoff(deadline=30.0):
            try:
                return do_thing()
            except OSError as e:
                attempt.note(e)   # remembered for the exhaustion error
        # falling off the loop means the deadline expired
        raise attempt.exhausted("connect to {0}".format(addr))

    Iteration yields the Backoff itself (as the attempt handle) and
    sleeps *between* attempts; the first attempt runs immediately.  The
    loop stops yielding once the next sleep would land past the
    deadline, so total wall clock stays <= ``deadline`` + one attempt.
    """

    def __init__(self, deadline=30.0, base=0.1, factor=2.0, max_delay=5.0,
                 sleep=time.sleep, rng=None, clock=time.monotonic):
        self.deadline = deadline
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.attempts = 0
        self.last_error = None
        self._sleep = sleep
        self._rng = rng if rng is not None else random
        #: deadline clock — monotonic by contract (wall-clock jumps
        #: must not expire or extend retry budgets); injectable so
        #: tests can drive it deterministically
        self._clock = clock
        self._end = None  # armed at first iteration, not construction

    def note(self, exc):
        """Record the attempt's failure (used in the exhaustion error)."""
        self.last_error = exc

    def __iter__(self):
        return self

    def __next__(self):
        now = self._clock()
        if self._end is None:
            self._end = now + self.deadline
        elif now >= self._end:
            raise StopIteration
        else:
            delay = min(
                self.max_delay,
                self.base * (self.factor ** (self.attempts - 1)),
            )
            # full jitter: uniform over [delay/2, delay]
            delay = self._rng.uniform(delay / 2.0, delay)
            delay = min(delay, max(0.0, self._end - now))
            if delay > 0:
                self._sleep(delay)
        self.attempts += 1
        return self

    def exhausted(self, what):
        """Build the RetryError for a loop that fell through."""
        err = RetryError(
            "{0} failed after {1} attempts over {2:.1f}s deadline: "
            "{3!r}".format(what, self.attempts, self.deadline,
                           self.last_error),
            last=self.last_error,
        )
        err.__cause__ = self.last_error
        return err


def retry_call(fn, what, exceptions=(OSError,), deadline=30.0, base=0.1,
               factor=2.0, max_delay=5.0, on_retry=None,
               clock=time.monotonic):
    """Call ``fn()`` until it returns, retrying ``exceptions`` with
    jittered exponential backoff under a hard ``deadline``.

    Args:
      fn: zero-arg callable.
      what: human description for logs and the exhaustion error, e.g.
        ``"connect to reservation server at ('10.0.0.1', 41121)"`` —
        the error a user sees MUST name the peer (satellite contract).
      exceptions: exception types treated as retryable; anything else
        propagates immediately.
      on_retry: optional ``fn(attempt_no, exc)`` hook called before each
        backoff sleep (used by callers to reset connections).

    Raises :class:`RetryError` (with ``__cause__`` set to the last
    underlying error) on deadline exhaustion.
    """
    bo = Backoff(deadline=deadline, base=base, factor=factor,
                 max_delay=max_delay, clock=clock)
    for attempt in bo:
        try:
            return fn()
        except exceptions as e:  # noqa: PERF203 - retry loop by design
            attempt.note(e)
            logger.warning("%s failed (attempt %d): %s — backing off",
                           what, attempt.attempts, e)
            if on_retry is not None:
                on_retry(attempt.attempts, e)
    raise bo.exhausted(what)
