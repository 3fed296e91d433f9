"""Cluster bootstrap rendezvous and the heartbeat liveness plane (port
of the JAX package's ``cluster/reservation.py``; original:
tensorflowonspark/reservation.py).

A TCP server on the driver that executors register with, plus a
client-side barrier.  Frames are 4-byte big-endian length + UTF-8 JSON
(never pickle on an open port).  Message vocabulary: REG / QINFO /
QUERY / STOP, plus HEARTBEAT / FAREWELL / LIVENESS for the liveness
registry: every node beats every ``HEARTBEAT_INTERVAL`` seconds with its
executor id, its rendezvous *generation* and whether its compute process
is alive, and :class:`Liveness` marks an executor dead after
``HEARTBEAT_MISS_THRESHOLD`` missed intervals, so the driver's monitor
names a dead worker in seconds.

Elastic supervision adds REBIRTH: a node whose compute process died
claims the next cluster generation (:meth:`Server.next_generation`),
re-registers under it, and every heartbeat reply carries the cluster
generation, so the surviving nodes learn of the rebirth.

The beats also carry the fleet's telemetry, so a node never opens a
second connection for it: a registry snapshot (:class:`MetricsStore`,
read back by METRICS), journal events (:class:`EventStore`, read back by
JOURNAL) and an NTP-style clock sample (:class:`ClockSync`: the reply
carries ``server_time``, the node ships its offset estimate on the next
beat).
"""

import collections
import json
import math
import logging
import os
import select
import socket
import struct
import threading
import time

from ..utils.retry import Backoff

logger = logging.getLogger(__name__)

#: Seconds between HEARTBEAT frames (env-tunable: TFOS_HEARTBEAT_INTERVAL).
HEARTBEAT_INTERVAL = float(os.environ.get("TFOS_HEARTBEAT_INTERVAL", "1.0"))

#: Missed intervals before an executor is declared dead (env-tunable:
#: TFOS_HEARTBEAT_MISS_THRESHOLD).
HEARTBEAT_MISS_THRESHOLD = int(
    os.environ.get("TFOS_HEARTBEAT_MISS_THRESHOLD", "3")
)

#: Env overrides for multi-homed driver hosts.
TFOS_SERVER_HOST = "TFOS_SERVER_HOST"
TFOS_SERVER_PORT = "TFOS_SERVER_PORT"

BUFSIZE = 1024 * 1024

#: Upper bound on a single frame: a bogus length prefix must not wedge
#: the select() loop in a gigabyte-sized blocking read.
MAX_FRAME = 16 * 1024 * 1024

#: Per-connection socket timeout on the server side, seconds.
SERVER_SOCKET_TIMEOUT = 10.0


class Reservations(object):
    """Thread-safe store of cluster reservations."""

    def __init__(self, required):
        self.required = required
        self._lock = threading.RLock()
        self._reservations = []

    def add(self, meta):
        """Add (or refresh) a reservation; idempotent per
        ``executor_id``, so a client that re-sent REG counts once."""
        with self._lock:
            key = meta.get("executor_id") if isinstance(meta, dict) else None
            if key is not None:
                for i, existing in enumerate(self._reservations):
                    if (isinstance(existing, dict)
                            and existing.get("executor_id") == key):
                        self._reservations[i] = meta
                        return
            self._reservations.append(meta)

    def done(self):
        with self._lock:
            return len(self._reservations) >= self.required

    def get(self):
        with self._lock:
            return list(self._reservations)

    def remaining(self):
        with self._lock:
            return self.required - len(self._reservations)


class Liveness(object):
    """Server-side heartbeat registry.

    An executor is *dead* when its newest beat is older than ``interval
    * miss_threshold`` or when its node reported ``compute_alive=False``
    (immediately).  Executors are only tracked once they have beaten.
    Each record carries the node's rendezvous generation.
    """

    def __init__(self, interval=None, miss_threshold=None):
        self.interval = (
            HEARTBEAT_INTERVAL if interval is None else float(interval)
        )
        self.miss_threshold = (
            HEARTBEAT_MISS_THRESHOLD
            if miss_threshold is None
            else int(miss_threshold)
        )
        self._lock = threading.Lock()
        self._beats = {}

    @property
    def deadline(self):
        """Seconds of silence after which an executor is dead."""
        return self.interval * self.miss_threshold

    def beat(self, executor_id, generation=0, compute_alive=True, host=""):
        with self._lock:
            self._beats[int(executor_id)] = {
                "t": time.monotonic(),
                "generation": int(generation),
                "compute_alive": bool(compute_alive),
                "host": host,
            }

    def forget(self, executor_id):
        """Drop an executor from tracking (its node left on purpose)."""
        with self._lock:
            self._beats.pop(int(executor_id), None)

    def tracked(self):
        """How many executors are tracked (have beaten, not left)."""
        with self._lock:
            return len(self._beats)

    def last_seen(self, executor_id):
        """Seconds since the executor's last beat; None if never seen."""
        with self._lock:
            rec = self._beats.get(int(executor_id))
        return None if rec is None else time.monotonic() - rec["t"]

    def generation(self, executor_id):
        """The executor's last reported generation (0 if never seen)."""
        with self._lock:
            rec = self._beats.get(int(executor_id))
        return 0 if rec is None else rec["generation"]

    def dead(self):
        """``{executor_id: diagnosis}`` for every tracked executor now
        considered dead; a diagnosis carries ``age`` (seconds of
        silence), ``reason`` and the last known ``host`` and
        ``generation``."""
        now = time.monotonic()
        out = {}
        with self._lock:
            for eid, rec in self._beats.items():
                age = now - rec["t"]
                if not rec["compute_alive"]:
                    reason = "node reported its compute process dead"
                elif age > self.deadline:
                    reason = (
                        "no heartbeat for {0:.1f}s (> {1} x {2:.1f}s "
                        "interval)".format(
                            age, self.miss_threshold, self.interval)
                    )
                else:
                    continue
                out[eid] = {"age": age, "reason": reason, "host": rec["host"],
                            "generation": rec["generation"]}
        return out

    def health(self):
        """The ``/healthz`` summary of this registry: healthy when no
        tracked executor is dead, with the dead executors' reasons and
        the oldest heartbeat age."""
        dead = self.dead()
        snap = self.snapshot()
        ages = [rec["age"] for rec in snap.values()]
        return {
            "healthy": not dead,
            "executors": len(snap),
            "dead": {str(eid): d["reason"] for eid, d in dead.items()},
            "max_heartbeat_age": round(max(ages), 3) if ages else None,
            "deadline": self.deadline,
        }

    def snapshot(self):
        """Age, generation, ``compute_alive`` and host of every tracked
        executor, keyed by the id as a string (the LIVENESS payload)."""
        now = time.monotonic()
        with self._lock:
            return {
                str(eid): {
                    "age": now - rec["t"],
                    "generation": rec["generation"],
                    "compute_alive": rec["compute_alive"],
                    "host": rec["host"],
                }
                for eid, rec in self._beats.items()
            }


class MetricsStore(object):
    """The newest telemetry snapshot of each executor, as the beats
    brought it; each record keeps its arrival time, so the driver can
    judge staleness."""

    def __init__(self):
        self._lock = threading.Lock()
        self._snaps = {}  # executor_id -> {"metrics": dict, "t": monotonic}

    def update(self, executor_id, snapshot):
        if not isinstance(snapshot, dict):
            return
        with self._lock:
            self._snaps[int(executor_id)] = {
                "metrics": snapshot,
                "t": time.monotonic(),
            }

    def forget(self, executor_id):
        with self._lock:
            self._snaps.pop(int(executor_id), None)

    def snapshot(self):
        """``{executor_id(str): {"metrics": dict, "age": seconds}}``."""
        now = time.monotonic()
        with self._lock:
            return {
                str(eid): {
                    "metrics": rec["metrics"],
                    "age": now - rec["t"],
                }
                for eid, rec in self._snaps.items()
            }


class ClockSync(object):
    """Each executor's clock offset, estimated from heartbeat round trips.

    NTP's client sample: the heartbeater notes ``t0`` (its wall clock)
    before a frame, the reply carries ``server_time``, and ``t1`` is its
    clock on receipt; on a symmetric path ``offset = server_time - (t0 +
    t1) / 2``, uncertain by at most ``rtt = t1 - t0``.  The node reports
    each sample on its next beat, and this registry keeps, per executor,
    the sample of the smallest rtt among the last :data:`CLOCK_WINDOW`
    (one cleanly timed exchange beats an average of queued ones).

    ``offset(eid)`` is what to add to that executor's wall-clock
    timestamps to put them on the server's (the driver's) clock.
    """

    #: Samples kept per executor for the min-rtt pick.
    CLOCK_WINDOW = 8

    def __init__(self):
        self._lock = threading.Lock()
        self._samples = {}  # eid -> deque[(rtt, offset)]

    def update(self, executor_id, offset, rtt):
        try:
            offset, rtt = float(offset), float(rtt)
        except (TypeError, ValueError):
            return
        if rtt < 0:
            return
        with self._lock:
            dq = self._samples.setdefault(
                int(executor_id),
                collections.deque(maxlen=self.CLOCK_WINDOW),
            )
            dq.append((rtt, offset))

    def offset(self, executor_id):
        """The min-rtt offset estimate in seconds; None when the executor
        never reported a sample."""
        with self._lock:
            dq = self._samples.get(int(executor_id))
            if not dq:
                return None
            return min(dq, key=lambda s: s[0])[1]

    def snapshot(self):
        """``{executor_id(str): {"offset": seconds, "rtt": seconds}}``."""
        with self._lock:
            out = {}
            for eid, dq in self._samples.items():
                if not dq:
                    continue
                rtt, off = min(dq, key=lambda s: s[0])
                out[str(eid)] = {"offset": off, "rtt": rtt}
            return out


def estimate_offset(t0, server_time, t1):
    """One NTP-style sample, ``(offset, rtt)``: a request sent at ``t0``
    (client clock), answered with ``server_time`` (server clock), received
    at ``t1`` (client clock)."""
    return float(server_time) - (float(t0) + float(t1)) / 2.0, (
        float(t1) - float(t0)
    )


class EventStore(object):
    """The fleet journal: the executors' typed events as the beats
    brought them, in one bounded ring (``TFOS_FLEET_JOURNAL_MAX``).

    A high-water seq per (executor, pid) drops repeats: seqs rise within
    a process, so an event at or below the mark was stored already, and
    a restarted compute process (a new pid) starts a mark of its own.
    """

    MAX_EVENTS = int(os.environ.get("TFOS_FLEET_JOURNAL_MAX", "8192"))

    def __init__(self, max_events=None):
        self._lock = threading.Lock()
        self._events = collections.deque(
            maxlen=self.MAX_EVENTS if max_events is None else int(max_events)
        )
        self._seen = {}  # (eid, pid) -> max seq stored

    def extend(self, executor_id, events):
        if not events:
            return 0
        eid = int(executor_id)
        stored = 0
        with self._lock:
            for ev in events:
                if not isinstance(ev, dict):
                    continue
                key = (eid, ev.get("pid", 0))
                seq = ev.get("seq", 0)
                if seq and seq <= self._seen.get(key, 0):
                    continue
                self._seen[key] = max(self._seen.get(key, 0), seq)
                rec = dict(ev)
                rec.setdefault("executor", eid)
                self._events.append(rec)
                stored += 1
        return stored

    def snapshot(self, limit=None):
        """The stored event dicts in time order (newest last)."""
        with self._lock:
            out = list(self._events)
        out.sort(key=lambda e: e.get("ts", 0.0))
        if limit is not None:
            out = out[-int(limit):]
        return out


def _jsonable(obj):
    """``obj`` with what JSON cannot carry replaced: numpy scalars become
    Python numbers, a float that is not finite becomes None, tuples
    become lists, anything else unknown its ``str``."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if hasattr(obj, "item") and not isinstance(obj, float):
        try:
            return _jsonable(obj.item())
        except (TypeError, ValueError):
            return str(obj)
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    return str(obj)


class MessageSocket(object):
    """Length-prefixed JSON framing over a TCP socket."""

    def receive(self, sock):
        header = self._recv_exact(sock, 4)
        if header is None:
            raise ConnectionError("connection closed while reading header")
        (length,) = struct.unpack(">I", header)
        if length > MAX_FRAME:
            raise ConnectionError(
                "frame length {0} exceeds limit; dropping connection".format(
                    length)
            )
        payload = self._recv_exact(sock, length)
        if payload is None:
            raise ConnectionError("connection closed while reading payload")
        return json.loads(payload.decode("utf-8"))

    def send(self, sock, msg):
        payload = json.dumps(msg).encode("utf-8")
        sock.sendall(struct.pack(">I", len(payload)) + payload)

    @staticmethod
    def _recv_exact(sock, n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(min(n - len(buf), BUFSIZE))
            if not chunk:
                return None
            buf += chunk
        return buf


class Server(MessageSocket):
    """Driver-side rendezvous server: single-thread ``select()`` loop."""

    def __init__(self, count, heartbeat_interval=None, miss_threshold=None):
        assert count > 0
        self.reservations = Reservations(count)
        self.liveness = Liveness(heartbeat_interval, miss_threshold)
        self.metrics = MetricsStore()
        self.events = EventStore()
        self.clocks = ClockSync()
        self.done = threading.Event()
        self._stop_requested = threading.Event()
        self._listener = None
        self._journal_listener = None
        #: elastic re-rendezvous generation, raised by REBIRTH frames
        self._generation = 0
        self._gen_lock = threading.Lock()

    @property
    def generation(self):
        with self._gen_lock:
            return self._generation

    def next_generation(self, executor_id, old_generation):
        """Atomically claim the generation a reborn executor joins.

        The first rebirth raises the cluster generation; a second
        executor dying in the same window joins that generation instead
        of raising it again (its ``old_generation`` is still the value
        before the deaths)."""
        with self._gen_lock:
            self._generation = max(self._generation, int(old_generation) + 1)
            gen = self._generation
        self.liveness.beat(executor_id, generation=gen)
        return gen

    @property
    def stop_requested(self):
        return self._stop_requested.is_set()

    def start(self):
        """Bind and start the background listener; returns ``(host,
        port)`` (env overrides ``TFOS_SERVER_HOST`` / ``_PORT``)."""
        from ..utils.net import get_ip_address

        host = os.environ.get(TFOS_SERVER_HOST, get_ip_address())
        port = int(os.environ.get(TFOS_SERVER_PORT, 0))
        server_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server_sock.bind(("", port))
        server_sock.listen(64)
        self._listener = server_sock
        addr = (host, server_sock.getsockname()[1])
        self.addr = addr
        t = threading.Thread(target=self._serve, args=(server_sock,),
                             daemon=True)
        t.start()
        logger.info("reservation server listening on %s", addr)
        return addr

    def _serve(self, server_sock):
        inputs = [server_sock]
        while not self.done.is_set():
            try:
                readable, _, exceptional = select.select(inputs, [], [], 1.0)
            except (OSError, ValueError):
                break
            for s in readable:
                if s is server_sock:
                    try:
                        conn, _ = server_sock.accept()
                        conn.settimeout(SERVER_SOCKET_TIMEOUT)
                        inputs.append(conn)
                    except OSError:
                        pass
                    continue
                try:
                    self._handle(s, self.receive(s))
                except (ConnectionError, OSError, json.JSONDecodeError):
                    inputs.remove(s)
                    s.close()
                except Exception:  # noqa: BLE001
                    # a malformed-but-valid-JSON frame must not kill the
                    # serve thread: answer with an error and keep going
                    logger.exception("error handling rendezvous message")
                    try:
                        self.send(s, {"type": "ERROR", "error": "bad request"})
                    except OSError:
                        inputs.remove(s)
                        s.close()
            for s in exceptional:
                if s in inputs:
                    inputs.remove(s)
                    s.close()
        for s in inputs:
            try:
                s.close()
            except OSError:
                pass

    def _handle(self, sock, msg):
        mtype = msg.get("type")
        if mtype == "REG":
            data = msg["data"]
            self.reservations.add(data)
            # a REG with a generation > 0 is an elastic re-rendezvous: it
            # primes the registry, so the monitor stops counting the old
            # incarnation's silence
            if isinstance(data, dict) and data.get("generation"):
                self.liveness.beat(data.get("executor_id", -1),
                                   generation=data.get("generation", 0),
                                   host=data.get("host", ""))
            self.send(sock, {"type": "OK"})
        elif mtype == "HEARTBEAT":
            eid = msg.get("executor_id", -1)
            self.liveness.beat(
                eid,
                generation=msg.get("generation", 0),
                compute_alive=msg.get("compute_alive", True),
                host=msg.get("host", ""),
            )
            if msg.get("metrics") is not None:
                self.metrics.update(eid, msg["metrics"])
            if msg.get("events"):
                self.events.extend(eid, msg["events"])
            clk = msg.get("clock")
            if isinstance(clk, dict):
                self.clocks.update(eid, clk.get("offset"), clk.get("rtt"))
            # the stop flag and the cluster generation ride the reply, so
            # heartbeaters double as the survivors' rebirth signal;
            # server_time is the clock sample the next beat reports back
            self.send(sock, {"type": "OK", "stop": self.stop_requested,
                             "generation": self.generation,
                             "server_time": time.time()})
        elif mtype == "FAREWELL":
            # orderly departure: a node whose work completed is never
            # misread as dead-by-silence
            self.liveness.forget(msg.get("executor_id", -1))
            self.send(sock, {"type": "OK"})
        elif mtype == "REBIRTH":
            gen = self.next_generation(msg.get("executor_id", -1),
                                       msg.get("generation", 0))
            self.send(sock, {"type": "REBIRTH_RESP", "generation": gen})
        elif mtype == "METRICS":
            self.send(sock, {
                "type": "METRICS_RESP",
                "executors": self.metrics.snapshot(),
                "liveness": self.liveness.snapshot(),
                "clocks": self.clocks.snapshot(),
                "generation": self.generation,
            })
        elif mtype == "JOURNAL":
            self.send(sock, {
                "type": "JOURNAL_RESP",
                "events": self.events.snapshot(limit=msg.get("limit")),
                "clocks": self.clocks.snapshot(),
                "generation": self.generation,
            })
        elif mtype == "LIVENESS":
            self.send(sock, {
                "type": "LIVENESS_RESP",
                "executors": self.liveness.snapshot(),
                "dead": {str(k): v for k, v in self.liveness.dead().items()},
                "generation": self.generation,
            })
        elif mtype == "QUERY":
            self.send(sock, {
                "type": "QUERY_RESP",
                "done": self.reservations.done(),
                "stop": self.stop_requested,
            })
        elif mtype == "QINFO":
            self.send(sock, {"type": "QINFO_RESP",
                             "reservations": self.reservations.get()})
        elif mtype == "STOP":
            self._stop_requested.set()
            self.send(sock, {"type": "OK"})
        else:
            self.send(sock, {"type": "ERROR",
                             "error": "unknown message %r" % mtype})

    def await_reservations(self, status=None, timeout=600):
        """Block until all nodes registered; abort on error status or
        timeout."""
        timespent = 0.0
        while not self.reservations.done():
            logger.info("waiting for %d reservations",
                        self.reservations.remaining())
            if status is not None and status.get("error"):
                raise RuntimeError(
                    "cluster startup aborted: {0}".format(status["error"])
                )
            time.sleep(1)
            timespent += 1
            if timespent > timeout:
                raise RuntimeError(
                    "timed out waiting for cluster reservations")
        logger.info("all reservations completed")
        return self.reservations.get()

    def attach_local_journal(self, executor_id=-1):
        """Feed this process's journal into the fleet :class:`EventStore`:
        the driver's own fault events (the monitor's ``executor_dead`` and
        ``executor_restart``) ride no heartbeat.  Events without an
        executor are stored under ``executor_id`` (-1, the driver).
        Idempotent; :meth:`stop` detaches it."""
        if self._journal_listener is not None:
            return self
        from ..telemetry import journal as _journal

        store, eid = self.events, int(executor_id)

        def _listener(ev):
            store.extend(eid, [_jsonable(ev.to_dict())])

        _journal.get_journal().add_listener(_listener)
        self._journal_listener = _listener
        return self

    def stop(self):
        self.done.set()
        if self._journal_listener is not None:
            from ..telemetry import journal as _journal

            _journal.get_journal().remove_listener(self._journal_listener)
            self._journal_listener = None
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass


class Client(MessageSocket):
    """Executor-side rendezvous client."""

    #: Client-side socket timeout: a stalled server surfaces as a
    #: retryable error, not an unbounded block.
    SOCKET_TIMEOUT = 30.0

    #: Wall-clock budget for connect / request retries.
    RETRY_DEADLINE = 30.0

    def __init__(self, server_addr, retry_deadline=None):
        self.server_addr = tuple(server_addr)
        if retry_deadline is not None:
            self.RETRY_DEADLINE = float(retry_deadline)
        self.sock = self._connect(self.server_addr, self.RETRY_DEADLINE)

    @staticmethod
    def _connect(addr, deadline=None):
        bo = Backoff(
            deadline=Client.RETRY_DEADLINE if deadline is None else deadline,
            base=0.2,
            max_delay=3.0,
        )
        for attempt in bo:
            try:
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                sock.settimeout(Client.SOCKET_TIMEOUT)
                sock.connect(addr)
                return sock
            except OSError as e:
                attempt.note(e)
                logger.warning(
                    "connect to reservation server at %s failed "
                    "(attempt %d): %s", addr, attempt.attempts, e,
                )
        raise ConnectionError(
            "unable to connect to reservation server at {0} within "
            "{1:.0f}s ({2} attempts): {3}".format(
                addr, bo.deadline, bo.attempts, bo.last_error)
        )

    def _request(self, msg):
        """Send with backoff + reconnect under a hard deadline."""
        bo = Backoff(deadline=self.RETRY_DEADLINE, base=0.2, max_delay=3.0)
        for attempt in bo:
            try:
                self.send(self.sock, msg)
                return self.receive(self.sock)
            except (ConnectionError, OSError) as e:
                attempt.note(e)
                logger.warning(
                    "lost connection to reservation server at %s "
                    "(attempt %d): %s; reconnecting",
                    self.server_addr, attempt.attempts, e,
                )
                try:
                    self.sock.close()
                except OSError:
                    pass
                self.sock = self._connect(self.server_addr,
                                          self.RETRY_DEADLINE)
        raise ConnectionError(
            "unable to reach reservation server at {0} within {1:.0f}s "
            "({2} attempts): {3}".format(
                self.server_addr, bo.deadline, bo.attempts, bo.last_error)
        )

    def register(self, reservation):
        return self._request({"type": "REG", "data": reservation})

    def get_reservations(self):
        return self._request({"type": "QINFO"})["reservations"]

    def await_reservations(self, timeout=600):
        """1s-poll barrier until the cluster is fully registered."""
        timespent = 0.0
        while not self._request({"type": "QUERY"})["done"]:
            time.sleep(1)
            timespent += 1
            if timespent > timeout:
                raise RuntimeError(
                    "timed out waiting for cluster reservations")
        return self.get_reservations()

    def request_stop(self):
        """Ask the server to set the cluster-wide stop flag."""
        return self._request({"type": "STOP"})

    def heartbeat(self, executor_id, generation=0, compute_alive=True,
                  host="", metrics=None, events=None, clock=None):
        """Send one HEARTBEAT frame; the reply carries the cluster-wide
        ``stop`` flag, the cluster generation and ``server_time``.
        ``metrics`` (a registry snapshot), ``events`` (journal event
        dicts) and ``clock`` (the latest ``{"offset", "rtt"}`` sample) ride
        the frame when given."""
        frame = {
            "type": "HEARTBEAT",
            "executor_id": int(executor_id),
            "generation": int(generation),
            "compute_alive": bool(compute_alive),
            "host": host,
        }
        if metrics is not None:
            frame["metrics"] = metrics
        if events:
            frame["events"] = list(events)
        if clock is not None:
            frame["clock"] = clock
        return self._request(frame)

    def get_metrics(self):
        """The server's per-executor telemetry snapshots and liveness:
        ``(executors, liveness)``, keyed by the executor id as a string;
        fold them with ``telemetry.aggregate.merge_snapshots``."""
        resp = self._request({"type": "METRICS"})
        return resp["executors"], resp.get("liveness", {})

    def get_journal(self, limit=None):
        """The fleet journal: ``(events, clocks)``, the time-ordered event
        dicts and the per-executor clock offsets that align them."""
        frame = {"type": "JOURNAL"}
        if limit is not None:
            frame["limit"] = int(limit)
        resp = self._request(frame)
        return resp["events"], resp.get("clocks", {})

    def get_liveness(self):
        """The server's liveness snapshot: ``(executors, dead)`` dicts
        keyed by the executor id as a string."""
        resp = self._request({"type": "LIVENESS"})
        return resp["executors"], resp["dead"]

    def farewell(self, executor_id):
        """Remove this executor from liveness tracking (orderly exit)."""
        return self._request({"type": "FAREWELL",
                              "executor_id": int(executor_id)})

    def rebirth(self, executor_id, generation):
        """Claim the generation a reborn executor rejoins under (see
        :meth:`Server.next_generation` for the simultaneous-death
        rule)."""
        resp = self._request({"type": "REBIRTH",
                              "executor_id": int(executor_id),
                              "generation": int(generation)})
        return int(resp["generation"])

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class Heartbeater(object):
    """Background thread pumping HEARTBEAT frames to the rendezvous
    server: the node-side half of the liveness plane.

    Args:
      server_addr: ``(host, port)`` of the rendezvous server.
      executor_id: this node's logical id.
      interval: seconds between beats (default ``HEARTBEAT_INTERVAL``).
      alive_fn: zero-arg callable polled each beat; its bool rides the
        frame as ``compute_alive`` so a node whose compute process died
        is reported immediately instead of after the miss threshold.
      generation_fn: zero-arg callable returning the node's rendezvous
        generation (elastic restarts raise it).
      metrics_fn: zero-arg callable returning a registry snapshot to ship
        on the beat.  A None return, or a fn that raises, ships a bare
        beat: liveness never depends on observability.
      events_fn: zero-arg callable returning journal event dicts to ship.
        Events whose beat failed are kept (the newest
        :data:`MAX_EVENT_BACKLOG`) and sent again with the next beat; the
        server's ``EventStore`` drops what it already holds.

    A beat that cannot reach the server is logged and dropped: missing
    frames is the very signal the server's registry measures, so the
    heartbeater never blocks or dies trying to be reliable.

    Every beat takes one NTP-style clock sample (``t0`` before the frame,
    the reply's ``server_time``, ``t1`` on receipt; :func:`estimate_offset`)
    and ships it on the next beat.  What rides a frame is made JSON-safe
    first (:func:`..telemetry.aggregate.wire_snapshot`, numpy scalars and
    non-finite floats in events).
    """

    #: Cap on the events kept while beats fail (the newest survive).
    MAX_EVENT_BACKLOG = 512

    def __init__(self, server_addr, executor_id, interval=None,
                 alive_fn=None, generation_fn=None, host="",
                 metrics_fn=None, events_fn=None):
        self.server_addr = tuple(server_addr)
        self.executor_id = int(executor_id)
        self.interval = (
            HEARTBEAT_INTERVAL if interval is None else float(interval)
        )
        self.alive_fn = alive_fn
        self.generation_fn = generation_fn
        self.host = host
        self.metrics_fn = metrics_fn
        self.events_fn = events_fn
        #: the newest cluster generation seen in a reply: supervisors
        #: poll it to learn that a peer was reborn
        self.cluster_generation = 0
        #: the latest ``{"offset", "rtt"}`` sample of this node against
        #: the server, shipped on the next beat
        self.clock = None
        self._event_backlog = []
        self._stop = threading.Event()
        self._client = None
        self._thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="heartbeat-%d" % self.executor_id,
        )
        self._thread.start()
        return self

    def beat_once(self):
        """Send a single beat synchronously (primes the registry so
        death-by-silence is measured from now)."""
        from ..telemetry.aggregate import wire_snapshot

        alive = True if self.alive_fn is None else bool(self.alive_fn())
        gen = 0 if self.generation_fn is None else int(self.generation_fn())
        metrics = None
        if self.metrics_fn is not None:
            try:
                metrics = wire_snapshot(self.metrics_fn())
            except Exception:  # noqa: BLE001 - see metrics_fn above
                metrics = None
        events = list(self._event_backlog)
        if self.events_fn is not None:
            try:
                events.extend(_jsonable(list(self.events_fn() or ())))
            except Exception:  # noqa: BLE001 - the journal is best effort
                pass
        events = events[-self.MAX_EVENT_BACKLOG:]
        t0 = time.time()
        try:
            if self._client is None:
                self._client = Client(self.server_addr,
                                      retry_deadline=max(1.0, self.interval))
            resp = self._client.heartbeat(
                self.executor_id, generation=gen, compute_alive=alive,
                host=self.host, metrics=metrics, events=events or None,
                clock=self.clock)
        except Exception:
            # the beat is dropped, the events it carried are not
            self._event_backlog = events
            raise
        t1 = time.time()
        self._event_backlog = []
        if resp.get("server_time") is not None:
            offset, rtt = estimate_offset(t0, resp["server_time"], t1)
            self.clock = {"offset": round(offset, 6), "rtt": round(rtt, 6)}
        self.cluster_generation = max(self.cluster_generation,
                                      int(resp.get("generation", 0)))

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.beat_once()
            except Exception as e:  # noqa: BLE001 - see class docstring
                logger.warning(
                    "heartbeat of executor %d to %s failed: %s "
                    "(will retry next interval)",
                    self.executor_id, self.server_addr, e,
                )
                if self._client is not None:
                    self._client.close()
                self._client = None

    def stop(self, farewell=True):
        """Stop beating; with ``farewell`` tell the server to drop this
        executor from tracking, so an orderly exit is not misread as
        death-by-silence."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)
        if farewell:
            try:
                if self._client is None:
                    self._client = Client(
                        self.server_addr,
                        retry_deadline=max(1.0, self.interval))
                self._client.farewell(self.executor_id)
            except Exception:  # noqa: BLE001 - server may already be down
                pass
        if self._client is not None:
            self._client.close()
            self._client = None
