"""Execution engines: the substrate that stands in for Spark (port of the
JAX package's ``engine.py``).

The executor fleet sits behind a small :class:`Engine` interface so the
cluster, data-plane and compute code run over :class:`LocalEngine`: N
executor *processes* on one host with Spark-like scheduling semantics.
Those semantics are load-bearing:

- each executor runs ONE task at a time (a 1-core executor);
- a task that blocks (TENSORFLOW-mode training) pins its executor, so
  feed tasks are only ever scheduled on free executors;
- a task failure fails the whole job and carries the remote traceback.

Functions and partitions travel to the executors with the standard
``pickle``, never ``cloudpickle``: a function is shipped by reference,
so it must be importable by module and name (a module-level function,
or a ``functools.partial`` of one), and closures are refused.  The
reference's ``SparkEngine`` is not ported (ROADMAP queue A).
"""

import logging
import multiprocessing
import os
import pickle
import queue as _queue_mod
import signal
import tempfile
import threading
import time
import traceback

logger = logging.getLogger(__name__)

#: Env var carrying the executor's working directory inside executor
#: processes (the executor-id file lives there).
TFOS_EXECUTOR_WORKDIR = "TFOS_EXECUTOR_WORKDIR"


class JobHandle(object):
    """Handle for an asynchronously launched job."""

    def __init__(self):
        self._done = threading.Event()
        self._results = None
        self._error = None

    def _complete(self, results=None, error=None):
        self._results = results
        self._error = error
        self._done.set()

    def wait(self, timeout=None):
        """Block until the job finishes; re-raises remote failure."""
        if not self._done.wait(timeout):
            raise TimeoutError("job did not complete within timeout")
        if self._error is not None:
            raise RuntimeError("job failed: {0}".format(self._error))
        return self._results

    def done(self):
        return self._done.is_set()

    @property
    def error(self):
        return self._error


class Engine(object):
    """Abstract executor-fleet interface (see module docstring)."""

    #: Whether :attr:`num_executors` is authoritative.
    num_executors_exact = False

    @property
    def num_executors(self):
        raise NotImplementedError

    @property
    def default_fs(self):
        """Filesystem root for relative paths."""
        return "file://"

    def run_job(self, mapfn, partitions, collect=False):
        """Run ``mapfn(iterator)`` over each partition; blocks.

        A partition is a list of rows or a zero-arg callable returning an
        iterable of rows (generated on the executor, so a dataset larger
        than driver memory never transits the driver).  Returns the
        concatenated per-partition results if ``collect``.
        """
        raise NotImplementedError

    def run_job_async(self, mapfn, partitions):
        """Launch a job without blocking; returns a :class:`JobHandle`."""
        handle = JobHandle()

        def _runner():
            try:
                handle._complete(
                    results=self.run_job(mapfn, partitions, collect=True))
            except Exception as e:  # noqa: BLE001 - job boundary
                logger.error("async job failed: %s", e)
                handle._complete(error="{0}".format(e))

        threading.Thread(target=_runner, daemon=True,
                         name="job-runner").start()
        return handle

    def stop(self):
        pass


def _executor_main(executor_idx, workdir, task_queue, result_queue,
                   env_overrides, cancelled):
    """Executor process main loop: pull (job_id, task_id, fn, partition)
    off the task queue, run it, report (job_id, task_id, ok, payload).
    Tasks of a job listed in ``cancelled`` are skipped without side
    effects (their job's waiter already raised)."""
    os.environ[TFOS_EXECUTOR_WORKDIR] = workdir
    os.environ.update(env_overrides or {})
    loglevel = os.environ.get("TFOS_EXECUTOR_LOGLEVEL")
    if loglevel:
        logging.basicConfig(
            level=getattr(logging, loglevel.upper(), logging.INFO),
            format="%(asctime)s exec-%(process)d %(levelname)s "
                   "%(name)s: %(message)s",
        )
    os.chdir(workdir)
    # own process group, so engine.stop() reaps the whole executor tree
    # (queue managers and compute processes included)
    try:
        os.setpgid(0, 0)
    except OSError:
        pass
    while True:
        item = task_queue.get()
        if item is None:
            break
        job_id, task_id, fn_bytes, part_bytes = item
        if job_id in cancelled:
            # a failed job's leftover tasks must not run: their queue puts
            # into node managers would corrupt later jobs' data plane
            result_queue.put((job_id, task_id, True, pickle.dumps([])))
            continue
        try:
            fn = pickle.loads(fn_bytes)
            partition = pickle.loads(part_bytes)
            if callable(partition):
                partition = partition()
            result = fn(iter(partition))
            result = list(result) if result is not None else []
            result_queue.put((job_id, task_id, True, pickle.dumps(result)))
        except Exception:  # noqa: BLE001 - task boundary, traceback shipped
            result_queue.put((job_id, task_id, False, traceback.format_exc()))


class LocalEngine(Engine):
    """N executor processes on one host with Spark-like task scheduling.

    ``deterministic=True`` routes task ``i`` to executor ``i % N``
    instead of letting free executors race for tasks, so
    partition-to-worker assignment is reproducible.
    """

    num_executors_exact = True

    def __init__(self, num_executors, env=None, start_method="spawn",
                 deterministic=False):
        self._deterministic = bool(deterministic)
        self._num_executors = num_executors
        self._ctx = multiprocessing.get_context(start_method)
        #: shared work-stealing queue XOR one private queue per executor
        self._task_queue = None if self._deterministic else self._ctx.Queue()
        self._task_queues = (
            [self._ctx.Queue() for _ in range(num_executors)]
            if self._deterministic else None
        )
        self._result_queue = self._ctx.Queue()
        # a Manager dict, so executors observe cancellations immediately
        self._mp_manager = self._ctx.Manager()
        self._cancelled = self._mp_manager.dict()
        self._job_counter = 0
        self._lock = threading.Lock()
        #: job_id -> local queue; one dispatcher thread routes results
        self._job_queues = {}
        self._dispatcher = threading.Thread(
            target=self._dispatch_results, daemon=True,
            name="engine-dispatch")
        self._dispatcher.start()
        self._tmpdir = tempfile.mkdtemp(prefix="tfos_torch_engine_")
        self._procs = []
        for i in range(num_executors):
            workdir = os.path.join(self._tmpdir, "executor-%d" % i)
            os.makedirs(workdir, exist_ok=True)
            # non-daemonic: executors spawn children (queue managers,
            # compute processes); stop() reaps them
            p = self._ctx.Process(
                target=_executor_main,
                args=(i, workdir,
                      self._task_queues[i] if self._deterministic
                      else self._task_queue,
                      self._result_queue, env or {}, self._cancelled),
                daemon=False,
                name="executor-%d" % i,
            )
            p.start()
            self._procs.append(p)
        logger.info("LocalEngine started %d executor processes under %s",
                    num_executors, self._tmpdir)

    @property
    def num_executors(self):
        return self._num_executors

    def _dispatch_results(self):
        while True:
            item = self._result_queue.get()
            if item is None:
                return
            with self._lock:
                q = self._job_queues.get(item[0])
            if q is not None:
                q.put(item)
            # else: straggler of a job whose waiter already gave up

    def run_job(self, mapfn, partitions, collect=False):
        results = []
        for part_result in self.run_job_lazy(mapfn, partitions):
            if collect:
                results.extend(part_result)
        return results if collect else None

    def run_job_lazy(self, mapfn, partitions):
        """Collect-style job as a generator: yields each partition's
        result list in partition order, as soon as it (and its
        predecessors) complete."""
        my_queue = _queue_mod.Queue()
        with self._lock:
            job_id = self._job_counter
            self._job_counter += 1
            self._job_queues[job_id] = my_queue
        deferred_cleanup = False
        try:
            fn_bytes = pickle.dumps(mapfn)
            for task_id, part in enumerate(partitions):
                payload = part if callable(part) else list(part)
                q = (self._task_queues[task_id % self._num_executors]
                     if self._deterministic else self._task_queue)
                q.put((job_id, task_id, fn_bytes, pickle.dumps(payload)))
            buffered = {}
            next_yield = 0
            remaining = len(partitions)
            while remaining:
                _, task_id, ok, payload = my_queue.get()
                if not ok:
                    # cancel the job's queued tasks; a reaper collects
                    # their acks, then retires the cancelled flag
                    try:
                        self._cancelled[job_id] = True
                    except (OSError, EOFError):
                        pass
                    deferred_cleanup = True
                    self._reap_cancelled(job_id, my_queue, remaining - 1)
                    raise RuntimeError(
                        "task {0} of job {1} failed:\n{2}".format(
                            task_id, job_id, payload))
                buffered[task_id] = pickle.loads(payload)
                remaining -= 1
                while next_yield in buffered:
                    yield buffered.pop(next_yield)
                    next_yield += 1
        finally:
            if not deferred_cleanup:
                with self._lock:
                    self._job_queues.pop(job_id, None)

    def _reap_cancelled(self, job_id, my_queue, remaining, deadline=60.0):
        """After a job fails: consume the acks of its remaining tasks in
        the background, then drop its queue and cancelled flag."""

        def _reap():
            left = remaining
            end = time.monotonic() + deadline
            while left > 0:
                try:
                    my_queue.get(timeout=max(0.1, end - time.monotonic()))
                    left -= 1
                except _queue_mod.Empty:
                    break  # executor wedged/killed: leave the flag in place
            with self._lock:
                self._job_queues.pop(job_id, None)
            if left == 0:
                try:
                    self._cancelled.pop(job_id, None)
                except (OSError, EOFError):
                    pass

        threading.Thread(target=_reap, daemon=True,
                         name="job-%d-reaper" % job_id).start()

    def stop(self):
        for i, _ in enumerate(self._procs):
            try:
                (self._task_queues[i] if self._deterministic
                 else self._task_queue).put(None)
            except (OSError, ValueError):
                pass
        try:
            self._result_queue.put(None)  # release the dispatcher thread
        except (OSError, ValueError):
            pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        try:
            self._mp_manager.shutdown()
        except Exception:  # noqa: BLE001 - already down
            pass
        # reap each executor's process group (managers, compute children)
        for p in self._procs:
            if p.pid:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except (OSError, ProcessLookupError):
                    pass
        logger.info("LocalEngine stopped")
