"""The elastic ``ClusterMonitor``'s marks: one warn ``executor_dead``
per death.

A rebirth reaches the liveness registry in this order (the supervisor's
``_final_beat``, the server's REBIRTH prime, the parked node's beats,
the respawned process's beats): dead at generation g, alive at g+1
(the prime), dead at g+1 while the node parks, then alive at g+1.  The
reference's monitor reopens its recovery window at the prime; the port
keeps that window and marks the death once.  A real second death, after
the node has been alive for longer than the liveness deadline, is
marked again.  The registry and the monitor are the real ones, polled by
hand.
"""

import time

from tensorflowonspark_tpu_torch import telemetry
from tensorflowonspark_tpu_torch.cluster import cluster, reservation

INTERVAL = 0.05


class _Server(object):
    def __init__(self):
        self.liveness = reservation.Liveness(interval=INTERVAL,
                                             miss_threshold=3)


def _dead_marks(eid):
    return [e for e in telemetry.get_journal().events()
            if e.kind == "executor_dead" and e.attrs.get("executor_id") == eid]


def _beats(monitor, server, eid, gen, alive, seconds):
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        server.liveness.beat(eid, generation=gen, compute_alive=alive,
                             host="h")
        monitor._poll()
        time.sleep(INTERVAL / 2)


def _one_rebirth(monitor, server, eid, gen):
    # the final beat of the dead process, then the server's prime
    _beats(monitor, server, eid, gen, False, INTERVAL)
    server.liveness.beat(eid, generation=gen + 1)
    monitor._poll()
    # parked until the re-rendezvous barrier, then respawned
    _beats(monitor, server, eid, gen + 1, False, 4 * INTERVAL)
    _beats(monitor, server, eid, gen + 1, True, 8 * INTERVAL)


def test_one_executor_dead_mark_per_death_through_a_rebirth():
    telemetry.get_journal().clear()
    server = _Server()
    monitor = cluster.ClusterMonitor(server, [], elastic=True,
                                     recovery_timeout=60.0)
    eid = 7
    _beats(monitor, server, eid, 0, True, 2 * INTERVAL)
    assert _dead_marks(eid) == []
    _one_rebirth(monitor, server, eid, 0)
    marks = _dead_marks(eid)
    assert len(marks) == 1
    assert marks[0].severity == "warn" and marks[0].attrs["recoverable"]
    assert monitor.restart_events == 1 and monitor.error is None
    # the window is the reference's: it closed once the node beat alive
    assert eid not in monitor._first_dead
    # a second death after a healthy stretch is a death of its own
    _one_rebirth(monitor, server, eid, 1)
    assert len(_dead_marks(eid)) == 2
    assert monitor.restart_events == 2 and monitor.error is None
