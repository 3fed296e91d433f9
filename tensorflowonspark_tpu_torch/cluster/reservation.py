"""Cluster bootstrap rendezvous and the heartbeat liveness plane (port
of the JAX package's ``cluster/reservation.py``; original:
tensorflowonspark/reservation.py).

A TCP server on the driver that executors register with, plus a
client-side barrier.  Frames are 4-byte big-endian length + UTF-8 JSON
(never pickle on an open port).  Message vocabulary: REG / QINFO /
QUERY / STOP, plus HEARTBEAT / FAREWELL for the liveness registry:
every node beats every ``HEARTBEAT_INTERVAL`` seconds with its executor
id and whether its compute process is alive, and :class:`Liveness`
marks an executor dead after ``HEARTBEAT_MISS_THRESHOLD`` missed
intervals, so the driver's monitor names a dead worker in seconds.

Not ported: the telemetry plane's ``MetricsStore``, ``EventStore`` and
``ClockSync`` (their METRICS / JOURNAL frames and the beats' metric,
event and clock payloads), and the LIVENESS and REBIRTH frames of
elastic supervision (ROADMAP queue A).
"""

import json
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

    def beat(self, executor_id, compute_alive=True, host=""):
        with self._lock:
            self._beats[int(executor_id)] = {
                "t": time.monotonic(),
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

    def dead(self):
        """``{executor_id: diagnosis}`` for every tracked executor now
        considered dead; a diagnosis carries ``age`` (seconds of
        silence), ``reason`` and the last known ``host``."""
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
                out[eid] = {"age": age, "reason": reason, "host": rec["host"]}
        return out


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
        self.done = threading.Event()
        self._stop_requested = threading.Event()
        self._listener = None

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
            self.reservations.add(msg["data"])
            self.send(sock, {"type": "OK"})
        elif mtype == "HEARTBEAT":
            self.liveness.beat(
                msg.get("executor_id", -1),
                compute_alive=msg.get("compute_alive", True),
                host=msg.get("host", ""),
            )
            self.send(sock, {"type": "OK", "stop": self.stop_requested})
        elif mtype == "FAREWELL":
            # orderly departure: a node whose work completed is never
            # misread as dead-by-silence
            self.liveness.forget(msg.get("executor_id", -1))
            self.send(sock, {"type": "OK"})
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

    def stop(self):
        self.done.set()
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

    def heartbeat(self, executor_id, compute_alive=True, host=""):
        """Send one HEARTBEAT frame; the reply carries the cluster-wide
        ``stop`` flag."""
        return self._request({
            "type": "HEARTBEAT",
            "executor_id": int(executor_id),
            "compute_alive": bool(compute_alive),
            "host": host,
        })

    def farewell(self, executor_id):
        """Remove this executor from liveness tracking (orderly exit)."""
        return self._request({"type": "FAREWELL",
                              "executor_id": int(executor_id)})

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

    A beat that cannot reach the server is logged and dropped: missing
    frames is the very signal the server's registry measures, so the
    heartbeater never blocks or dies trying to be reliable.
    """

    def __init__(self, server_addr, executor_id, interval=None,
                 alive_fn=None, host=""):
        self.server_addr = tuple(server_addr)
        self.executor_id = int(executor_id)
        self.interval = (
            HEARTBEAT_INTERVAL if interval is None else float(interval)
        )
        self.alive_fn = alive_fn
        self.host = host
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
        alive = True if self.alive_fn is None else bool(self.alive_fn())
        if self._client is None:
            self._client = Client(self.server_addr,
                                  retry_deadline=max(1.0, self.interval))
        self._client.heartbeat(self.executor_id, compute_alive=alive,
                               host=self.host)

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
