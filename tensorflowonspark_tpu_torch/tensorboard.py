"""Managed TensorBoard processes and on-demand device profiling with
``torch.profiler`` (port of the JAX package's ``tensorboard.py``;
original: tensorflowonspark/TFSparkNode.py:260-297, TFCluster.py:207-212).

:func:`start_tensorboard` launches TensorBoard over a log directory on a
port from :data:`TENSORBOARD_PORT` or an ephemeral one;
``cluster.run(tensorboard=True, log_dir=)`` starts it on one node, which
publishes its port, and ``TPUCluster.shutdown`` stops it with SIGTERM.
Without a TensorBoard (none on ``PATH`` and none importable) it logs a
warning and returns ``(None, 0)``: the cluster comes up without it.

:func:`start_profile` starts a trace of the CPU and, where a card is
present, of CUDA; its :class:`ProfileSession` counts work units (the
serving engine's decode chunks, ``train_on_feed``'s steps) as profiler
steps and stops itself after ``num_steps`` of them, writing a Chrome
trace (``<host>_<pid>.<ms>.pt.trace.json``, the name TensorBoard's
profiler plugin reads) into the log directory.

Three ways in: ``serving_builder``'s ``profile_dir``/``profile_steps``
(through the engine); ``cluster.run(profile_dir=, profile_steps=)``,
which hands :data:`PROFILE_DIR_ENV`/:data:`PROFILE_STEPS_ENV` to that
cluster's compute processes only, each starting its capture with
:func:`maybe_start_profile_from_env` into ``<dir>/<pid>``; and the health
plane's ``profile_request`` (``telemetry.aggregate.NodePublisher``),
which :func:`request_profile` hands to the training thread.

A ``torch.profiler`` session records the thread that starts it and must
be stepped and stopped there, so a capture asked for from another thread
starts at that thread's next :func:`profile_step`.  A process holds at
most one live session: a second start returns None.
"""

import logging
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

logger = logging.getLogger(__name__)

#: The environment variable naming TensorBoard's port (0 or unset: an
#: ephemeral one).
TENSORBOARD_PORT = "TENSORBOARD_PORT"

#: The environment of a compute process that should capture a trace
#: into ``$TFOS_PROFILE_DIR/<pid>`` (for ``$TFOS_PROFILE_STEPS`` steps).
PROFILE_DIR_ENV = "TFOS_PROFILE_DIR"
PROFILE_STEPS_ENV = "TFOS_PROFILE_STEPS"

#: The process's live session (``torch.profiler`` traces one at a time);
#: :func:`profile_step` feeds it from the training loop.
_ACTIVE_SESSION = None

#: A capture another thread asked for: ``(log_dir, num_steps, on_start)``
_PENDING = [None]
_PENDING_LOCK = threading.Lock()


def request_profile(log_dir, num_steps=None, on_start=None):
    """Ask the thread that calls :func:`profile_step` to start a capture
    into ``log_dir`` at its next step boundary; ``on_start(session or
    None)`` is called there once it was tried.  Returns False (and
    starts nothing) while a session is live or another request waits."""
    with _PENDING_LOCK:
        if _ACTIVE_SESSION is not None or _PENDING[0] is not None:
            return False
        _PENDING[0] = (log_dir, num_steps, on_start)
    return True


def cancel_request():
    """Withdraw a request no step boundary served; returns it, or None."""
    with _PENDING_LOCK:
        req, _PENDING[0] = _PENDING[0], None
    return req


def active_session():
    """The process's live :class:`ProfileSession`, or None."""
    return _ACTIVE_SESSION


def profile_step(n=1):
    """Count ``n`` work units against the live session, if any; with no
    session, start the capture :func:`request_profile` asked for."""
    sess = _ACTIVE_SESSION
    if sess is not None:
        sess.step(n)
    elif _PENDING[0] is not None:
        req = cancel_request()
        if req is not None:
            log_dir, num_steps, on_start = req
            sess = start_profile(log_dir, num_steps)
            if on_start is not None:
                on_start(sess)


class ProfileSession(object):
    """One live ``torch.profiler`` trace.  ``step(n)`` counts ``n`` work
    units; once ``num_steps`` have passed the trace stops and is written.
    ``stop()`` is idempotent; ``trace_path`` names the written file and
    ``stop_sec`` the seconds the stop took (the wait for queued kernels,
    the profiler's stop and the export)."""

    def __init__(self, prof, log_dir, num_steps=None, cuda=False):
        self._prof = prof
        self._cuda = cuda
        self.log_dir = log_dir
        self.remaining = None if num_steps is None else int(num_steps)
        self.trace_path = None
        self.stop_sec = None
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
        global _ACTIVE_SESSION
        if not self._active:
            return
        self._active = False
        if _ACTIVE_SESSION is self:
            _ACTIVE_SESSION = None
        t0 = time.perf_counter()
        try:
            if self._cuda:
                # the kernels of the counted steps may still be queued:
                # the trace holds them only once they ran
                import torch

                torch.cuda.synchronize()
            self._prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            name = "{0}_{1}.{2}.pt.trace.json".format(
                socket.gethostname(), os.getpid(), int(time.time() * 1e3))
            path = os.path.join(self.log_dir, name)
            self._prof.export_chrome_trace(path)
            self.trace_path = path
            self.stop_sec = time.perf_counter() - t0
            logger.info("torch.profiler trace written to %s in %.2f s", path,
                        self.stop_sec)
        except Exception as e:  # noqa: BLE001 - profiling is best effort
            logger.warning("writing the torch.profiler trace failed: %s", e)


def start_profile(log_dir, num_steps=None):
    """Start a ``torch.profiler`` trace that will be written into
    ``log_dir``; returns a :class:`ProfileSession`, or None when the
    profiler cannot start or a session is already live in this process
    (the run goes on unprofiled).  CUDA activity is recorded whenever a
    card is present."""
    global _ACTIVE_SESSION
    if _ACTIVE_SESSION is not None:
        logger.warning("a torch.profiler trace into %s is already live; "
                       "not starting another into %s",
                       _ACTIVE_SESSION.log_dir, log_dir)
        return None
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
    _ACTIVE_SESSION = ProfileSession(prof, log_dir, num_steps,
                                     cuda=len(activities) > 1)
    return _ACTIVE_SESSION


def maybe_start_profile_from_env():
    """Start the capture :data:`PROFILE_DIR_ENV` asks for, into
    ``<dir>/<pid>``; None when it is unset.  A capture that was asked for
    and cannot start raises (the reference degrades to no capture)."""
    log_dir = os.environ.get(PROFILE_DIR_ENV)
    if not log_dir:
        return None
    steps = os.environ.get(PROFILE_STEPS_ENV)
    sub = os.path.join(log_dir, str(os.getpid()))
    sess = start_profile(sub, int(steps) if steps else None)
    if sess is None:
        raise RuntimeError("the profile capture into {0} that {1} asks for "
                           "did not start".format(sub, PROFILE_DIR_ENV))
    return sess


def find_tensorboard():
    """The command that runs TensorBoard: the ``tensorboard`` executable
    on ``PATH``, else this interpreter's ``-m tensorboard.main`` when the
    package imports, else None."""
    tb = shutil.which("tensorboard")
    if tb:
        return [tb]
    try:
        import tensorboard  # noqa: F401
    except ImportError:
        return None
    return [sys.executable, "-m", "tensorboard.main"]


def start_tensorboard(log_dir, port=None):
    """Launch TensorBoard over ``log_dir``; returns ``(proc, port)``, or
    ``(None, 0)`` (with a warning) when there is no TensorBoard or no
    ``log_dir``."""
    cmd = find_tensorboard()
    if cmd is None or not log_dir:
        logger.warning("tensorboard unavailable or no log_dir; skipping")
        return None, 0
    if port is None:
        port = int(os.environ.get(TENSORBOARD_PORT, 0))
    if not port:
        from .utils.net import free_port

        port = free_port()
    proc = subprocess.Popen(
        cmd + ["--logdir=%s" % log_dir, "--port=%d" % port, "--bind_all"],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )
    logger.info("started tensorboard pid=%d port=%d", proc.pid, port)
    return proc, port
