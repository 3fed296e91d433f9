"""Deterministic chaos injection for fault-tolerance tests (port of the
JAX package's ``testing/chaos.py``, cut to the kill-worker fault).

A :class:`ChaosPlan` is written to a JSON file and advertised through
the ``TFOS_CHAOS_PLAN`` env var; the user fn under test builds
:func:`step_fault_fn` and calls the returned hook once per training step
(``SyncTrainer.train_on_feed(step_callback=...)``).  The kill is a
SIGKILL to the compute process's own pid: no exit handlers, no
error-queue post, which is what a preemption or an OOM kill looks like
to the rest of the system.  Every fault is reproducible: a chaos test
that fails fails the same way every run.

Nothing here imports ``torch``: executors load the plan too.  Nothing
runs unless a test opts in: with ``TFOS_CHAOS_PLAN`` unset the hook is a
no-op.

Not ported (ROADMAP queue A, item 14): the other faults of the
reference's plan (heartbeat drops, slow executors, leader kills, serving
and swap faults) and ``TcpGremlin``.
"""

import json
import logging
import os
import signal

logger = logging.getLogger(__name__)

#: Env var naming the JSON chaos-plan file executors should load.
TFOS_CHAOS_PLAN = "TFOS_CHAOS_PLAN"


class ChaosPlan(object):
    """A deterministic fault plan, serialisable to the plan file::

        plan = ChaosPlan().kill_worker(executor_id=1, at_step=5)
        engine = LocalEngine(2, env=plan.env(plan.save(path)))
    """

    def __init__(self, faults=None):
        self.faults = list(faults or [])

    def kill_worker(self, executor_id, at_step):
        """SIGKILL executor ``executor_id``'s compute process the first
        time its step counter reaches ``at_step``.  Several kills of one
        executor belong to its successive incarnations, in plan order
        (see :func:`step_fault_fn`)."""
        self.faults.append({"kind": "kill", "executor_id": int(executor_id),
                            "at_step": int(at_step)})
        return self

    def save(self, path):
        path = os.fspath(path)
        with open(path, "w") as f:
            json.dump({"faults": self.faults}, f)
        return path

    def env(self, path):
        """The env dict to hand a ``LocalEngine`` so executors see the
        plan."""
        return {TFOS_CHAOS_PLAN: os.fspath(path)}

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls(json.load(f).get("faults", []))


def load_plan():
    """The plan advertised through ``TFOS_CHAOS_PLAN``, or None."""
    path = os.environ.get(TFOS_CHAOS_PLAN)
    if not path:
        return None
    try:
        return ChaosPlan.load(path)
    except (OSError, ValueError):
        logger.warning("unreadable chaos plan at %r", path, exc_info=True)
        return None


def step_fault_fn(ctx):
    """The per-step fault hook of this compute process: ``fault(step)``
    SIGKILLs the process when a ``kill`` fault of its executor is due.

    Kill ``i`` of an executor belongs to its incarnation ``i``
    (``ctx.generation``): the process reborn after a kill does not
    re-trigger it when it replays the step from its checkpoint, and a
    second kill in the plan arms the first reborn process.  With no
    plan the hook does nothing.
    """
    plan = load_plan()
    if plan is None:
        return lambda step: None
    kills = [f for f in plan.faults
             if f["kind"] == "kill" and f["executor_id"] == ctx.executor_id]
    generation = getattr(ctx, "generation", 0)

    def fault(step):
        for i, f in enumerate(kills):
            if i == generation and step >= f["at_step"]:
                logger.warning(
                    "chaos: killing executor %d compute (pid %d) at step "
                    "%d per plan", ctx.executor_id, os.getpid(), step)
                os.kill(os.getpid(), signal.SIGKILL)

    return fault
