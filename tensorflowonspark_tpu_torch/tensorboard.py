"""On-demand device profiling with ``torch.profiler`` (port of the
profiling hook of the JAX package's ``tensorboard.py``; managed
TensorBoard processes are not ported yet).

:func:`start_profile` starts a trace of the CPU and, where a card is
present, of CUDA; its :class:`ProfileSession` counts work units
(the serving engine's decode chunks) as profiler steps and stops itself
after ``num_steps`` of them, writing a Chrome trace
(``<host>_<pid>.<ms>.pt.trace.json``, the name TensorBoard's profiler
plugin reads) into the log directory.  The serving builder's
``profile_dir``/``profile_steps`` reach it through the engine.
"""

import logging
import os
import socket
import time

logger = logging.getLogger(__name__)


class ProfileSession(object):
    """One live ``torch.profiler`` trace.  ``step(n)`` counts ``n`` work
    units; once ``num_steps`` have passed the trace stops and is written.
    ``stop()`` is idempotent; ``trace_path`` names the written file."""

    def __init__(self, prof, log_dir, num_steps=None):
        self._prof = prof
        self.log_dir = log_dir
        self.remaining = None if num_steps is None else int(num_steps)
        self.trace_path = None
        self._active = True

    def step(self, n=1):
        """Count ``n`` completed work units; returns True while the trace
        is live."""
        if not self._active:
            return False
        for _ in range(int(n)):
            self._prof.step()
        if self.remaining is not None:
            self.remaining -= int(n)
            if self.remaining <= 0:
                self.stop()
        return self._active

    def stop(self):
        if not self._active:
            return
        self._active = False
        try:
            self._prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            name = "{0}_{1}.{2}.pt.trace.json".format(
                socket.gethostname(), os.getpid(), int(time.time() * 1e3))
            path = os.path.join(self.log_dir, name)
            self._prof.export_chrome_trace(path)
            self.trace_path = path
            logger.info("torch.profiler trace written to %s", path)
        except Exception as e:  # noqa: BLE001 - profiling is best effort
            logger.warning("writing the torch.profiler trace failed: %s", e)


def start_profile(log_dir, num_steps=None):
    """Start a ``torch.profiler`` trace that will be written into
    ``log_dir``; returns a :class:`ProfileSession`, or None when the
    profiler cannot start (the run goes on unprofiled).  CUDA activity is
    recorded whenever a card is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities)
        prof.start()
    except Exception as e:  # noqa: BLE001 - profiling is never worth a
        logger.warning(  # crash: the run proceeds unprofiled
            "torch.profiler unavailable (%s); continuing unprofiled", e)
        return None
    logger.info("torch.profiler trace started into %s%s", log_dir,
                "" if num_steps is None else " (%d steps)" % num_steps)
    return ProfileSession(prof, log_dir, num_steps)
