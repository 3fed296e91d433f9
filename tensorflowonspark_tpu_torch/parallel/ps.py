"""Asynchronous parameter-server data parallelism (port of the JAX
package's ``parallel/ps.py``; original: the ``ParameterServerStrategy``
runtime that tensorflowonspark's ps nodes ran, TFSparkNode.py:409-426).

- :class:`ParamServerShard`: a TCP service holding a shard of the
  model's leaves in host memory and applying updates with its own numpy
  optimizer.  It never touches a GPU: a ps node imports ``torch`` but
  creates no CUDA tensor.
- :class:`PSClient`: the worker's side.  It partitions a parameter tree
  across the shards (size-balanced, large leaves split by rows), then
  ``push_pull(grads)`` ships gradients and returns fresh parameters in
  one round trip per shard (async SGD; no barrier between workers).
- :func:`run_server`: what a ps-role node runs inside ``main_fun``.
- :class:`AsyncTrainer`: gradients on the worker's device
  (``torch.autograd.grad`` over leaf tensors), the round trip, and the
  fresh parameters copied back onto the device.

The wire is the reference's, byte for byte: a 4-byte big-endian header
length, a JSON header, then raw tensor payloads (no pickle), sent with
``socket.sendmsg`` scatter-gather.  A tensor entry may carry a ``codec``
(:mod:`..compress`: int8, top-k) with per-part metadata; once a
connection negotiates a reply codec (the ``codec`` op) the shard sends
its parameter replies as compressed deltas against that connection's
view.  Optimizers are named specs (``("adam", {"learning_rate":
1e-3})``) resolved against the shard's numpy implementations.

Host trees: dicts (flattened in sorted key order, as ``jax.tree_util``
does), lists and tuples, with numpy arrays or ``torch`` tensors at the
leaves; replies come back as numpy arrays in the same structure.  A
bfloat16 leaf crosses as its bits (:data:`..compress.BFLOAT16`), named
``"bfloat16"`` on the wire.

A bf16 leaf is updated in float32 on the shard and stays float32 from its
first update on, which is what the reference's numpy does (a Python float
times an ``ml_dtypes`` bf16 array is float32): SGD's update is the
reference's to the bit, Adam's and Adagrad's first one is not (the
reference rounds ``grad * grad`` to bf16 there).  A deliberate
difference: a delta reply names a bf16 leaf's dtype ``"bfloat16"``; the
reference writes ``dtype.str``, ``'<V2'``, which its own client casts to
raw void bytes.  The port's client reads both.

Not ported: ``topology="hierarchical"`` (``parallel/hier_ps.py``; ROADMAP
queue A, A14).
"""

import json
import logging
import queue as _queue_mod
import socket
import struct
import threading
import time

import numpy as np

from .. import compress as compress_mod
from ..utils import not_ported as _not_ported

logger = logging.getLogger(__name__)

_MAX_HEADER = 16 * 1024 * 1024


# ----------------------------------------------------------------------
# framing: JSON header + raw tensor payloads
# ----------------------------------------------------------------------


def _recv_exact(sock, n):
    """``n`` bytes off the socket, received in place into one writable
    buffer (no chunk list, no final copy: a push or reply is hundreds of
    megabytes at the flagship's width)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(1 << 22, n - got))
        if not k:
            raise ConnectionError("socket closed mid-frame")
        got += k
    return buf


#: sendmsg iovec batch bound (Linux IOV_MAX is 1024; stay well under)
_IOV_MAX = 512


def _sendmsg_all(sock, views):
    """Scatter-gather send of a list of memoryviews; returns the bytes
    sent.  The payload arrays go to the kernel in place; ``sendall`` of
    the joined bytes where ``sendmsg`` is missing."""
    total = sum(v.nbytes for v in views)
    if not hasattr(sock, "sendmsg"):
        sock.sendall(b"".join(views))
        return total
    pending = [v for v in views if v.nbytes]
    while pending:
        sent = sock.sendmsg(pending[:_IOV_MAX])
        while sent > 0 and pending:
            v = pending[0]
            if sent >= v.nbytes:
                sent -= v.nbytes
                pending.pop(0)
            else:
                pending[0] = v[sent:]
                sent = 0
    return total


def _part_meta(p):
    return {"dtype": compress_mod.dtype_str(p.dtype),
            "shape": list(p.shape), "nbytes": int(p.nbytes)}


def _payload_view(p):
    """Byte view of a contiguous payload array."""
    try:
        return memoryview(p).cast("B")
    except (ValueError, TypeError):
        return memoryview(p.reshape(-1).view(np.uint8))


def _send_frame(sock, header, entries):
    """Lay one frame on the socket: ``entries`` is a list of
    ``(tensor_meta, [payload arrays])``; returns the bytes sent."""
    meta = []
    payloads = []
    for m, parts in entries:
        parts = [compress_mod.contiguous(p) for p in parts]
        if m.get("codec"):
            m = dict(m, parts=[_part_meta(p) for p in parts])
        meta.append(m)
        payloads.extend(parts)
    hb = json.dumps(dict(header, tensors=meta)).encode("utf-8")
    views = [memoryview(struct.pack(">I", len(hb))), memoryview(hb)]
    views.extend(_payload_view(p) for p in payloads)
    return _sendmsg_all(sock, views)


def send_msg(sock, header, tensors=None, codec=None):
    """Send ``header`` (a JSON-able dict) and named numpy ``tensors``.

    With ``codec`` (a :class:`~..compress.Codec` or an
    :class:`~..compress.ErrorFeedback`) each tensor ships as the codec's
    encoded parts under a codec header that :func:`recv_msg` decodes by.
    Returns the bytes laid on the wire (length prefix, header and
    payloads).
    """
    tensors = tensors or {}
    entries = []
    for name, arr in tensors.items():
        if codec is not None and not isinstance(codec, compress_mod.NoneCodec):
            if hasattr(codec, "encode_named"):  # error-feedback wrapper
                parts, cmeta = codec.encode_named(name, arr)
            else:
                parts, cmeta = codec.encode(np.asarray(arr))
            entries.append(
                ({"name": name, "codec": codec.name, "meta": cmeta}, parts)
            )
        else:
            arr = compress_mod.contiguous(arr)
            entries.append((dict(_part_meta(arr), name=name), [arr]))
    return _send_frame(sock, header, entries)


def _recv_part(sock, m):
    """Receive one payload described by part-meta ``m``; meta whose
    ``nbytes`` disagrees with dtype x shape is refused before any
    allocation."""
    try:
        dtype = compress_mod.resolve_dtype(m["dtype"])
        shape = tuple(int(s) for s in m["shape"])
        nbytes = int(m["nbytes"])
    except (KeyError, TypeError, ValueError) as e:
        raise ConnectionError("bad tensor meta: {0}".format(e))
    expect = int(dtype.itemsize * int(np.prod(shape, dtype=np.int64)))
    if nbytes != expect or nbytes < 0 or any(s < 0 for s in shape):
        raise ConnectionError(
            "tensor meta nbytes {0} inconsistent with dtype/shape "
            "({1} expected)".format(nbytes, expect)
        )
    raw = _recv_exact(sock, nbytes)
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


def recv_msg(sock):
    """Receive one message: ``(header, {name: np.ndarray})``.

    Codec entries are decoded to dense arrays here.  Undecodable or
    inconsistent frames raise ``ConnectionError``.  The header carries
    ``_recv_nbytes``, the frame's exact wire bytes (the receive-side
    twin of :func:`send_msg`'s return value).
    """
    (hlen,) = struct.unpack(">I", _recv_exact(sock, 4))
    if hlen > _MAX_HEADER:
        raise ConnectionError("header length {0} exceeds limit".format(hlen))
    try:
        header = json.loads(_recv_exact(sock, hlen).decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise ConnectionError("undecodable frame header: {0}".format(e))
    if not isinstance(header, dict):
        raise ConnectionError("frame header is not an object")
    nbytes = 4 + hlen
    tensors = {}
    for m in header.get("tensors", ()):
        if m.get("codec"):
            codec = compress_mod.get_codec(str(m["codec"]))
            parts = [_recv_part(sock, pm) for pm in m.get("parts", ())]
            nbytes += sum(int(p.nbytes) for p in parts)
            try:
                tensors[m["name"]] = codec.decode(parts, m.get("meta") or {})
            except (KeyError, TypeError, ValueError, IndexError) as e:
                raise ConnectionError(
                    "codec {0} decode failed: {1}".format(m["codec"], e)
                )
        else:
            part = _recv_part(sock, m)
            nbytes += int(part.nbytes)
            tensors[m["name"]] = part
    header["_recv_nbytes"] = nbytes
    return header, tensors


# ----------------------------------------------------------------------
# the shard's numpy optimizers (leafwise; no code deserialization)
# ----------------------------------------------------------------------


class _SGD(object):
    def __init__(self, learning_rate=0.01, momentum=0.0):
        self.lr = learning_rate
        self.momentum = momentum
        self._vel = {}

    def update(self, name, param, grad):
        if self.momentum:
            v = self._vel.get(name)
            v = grad if v is None else self.momentum * v + grad
            self._vel[name] = v
            grad = v
        return param - self.lr * grad


class _Adagrad(object):
    def __init__(self, learning_rate=0.01, eps=1e-10):
        self.lr = learning_rate
        self.eps = eps
        self._acc = {}

    def update(self, name, param, grad):
        acc = self._acc.get(name, np.zeros_like(param)) + grad * grad
        self._acc[name] = acc
        return param - self.lr * grad / (np.sqrt(acc) + self.eps)


class _Adam(object):
    def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8):
        self.lr = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self._m, self._v, self._t = {}, {}, {}

    def update(self, name, param, grad):
        t = self._t.get(name, 0) + 1
        m = self.b1 * self._m.get(name, np.zeros_like(param)) + (1 - self.b1) * grad
        v = self.b2 * self._v.get(name, np.zeros_like(param)) + (
            1 - self.b2
        ) * grad * grad
        self._m[name], self._v[name], self._t[name] = m, v, t
        mhat = m / (1 - self.b1**t)
        vhat = v / (1 - self.b2**t)
        return param - self.lr * mhat / (np.sqrt(vhat) + self.eps)


class _Delta(object):
    """The hierarchical plane's rule: the pushed tensor is a parameter
    delta, folded in as ``param + scale * delta``."""

    def __init__(self, scale=1.0):
        self.scale = scale

    def update(self, name, param, grad):
        return param + self.scale * grad


OPTIMIZERS = {"sgd": _SGD, "adagrad": _Adagrad, "adam": _Adam,
              "delta": _Delta}


def _build_optimizer(spec):
    name, kwargs = spec
    if name not in OPTIMIZERS:
        raise ValueError(
            "unknown PS optimizer {0!r}; supported: {1}".format(
                name, sorted(OPTIMIZERS)
            )
        )
    return OPTIMIZERS[name](**(kwargs or {}))


def _apply_update(opt, name, param, grad):
    """One optimizer update of a leaf.  A bf16 leaf is updated in float32
    and stays float32 from then on, as the reference's numpy promotes it
    (a Python float times an ``ml_dtypes`` bf16 array is float32); a bf16
    gradient is widened first."""
    if compress_mod.is_bf16(param.dtype):
        param = compress_mod.widen(param)
    if compress_mod.is_bf16(grad.dtype):
        grad = compress_mod.widen(grad)
    return opt.update(name, param, grad.astype(param.dtype, copy=False))


# ----------------------------------------------------------------------
# server
# ----------------------------------------------------------------------


class _ReplyCompressor(object):
    """Per-connection compressed-delta replies.

    Once a connection negotiates a reply codec, each parameter reply
    ships the lossy-encoded delta against the *client view*, exactly what
    the client has reconstructed so far.  The view advances by the
    server's own decode of the encoded delta (bit-identical to the
    client's decode of the same bytes), so encoding error never drifts
    the two apart.  A tensor's first reply (or one after a shape change)
    ships dense, establishing the base.
    """

    def __init__(self):
        self.codec = None
        self._view = {}

    def negotiate(self, spec):
        codec = compress_mod.get_codec(spec)
        if codec is not None and isinstance(codec, compress_mod.NoneCodec):
            codec = None
        self.codec = codec
        self._view.clear()

    def entries(self, tensors):
        """Frame entries for a parameter reply (see :func:`_send_frame`)."""
        entries = []
        for name, arr in tensors.items():
            arr = np.asarray(arr)
            view = self._view.get(name)
            if view is None or view.shape != arr.shape:
                self._view[name] = compress_mod.widen(arr, copy=True)
                dense = compress_mod.contiguous(arr)
                entries.append((dict(_part_meta(dense), name=name), [dense]))
                continue
            delta = compress_mod.widen(arr) - view
            parts, meta = self.codec.encode(delta)
            approx = compress_mod.widen(
                self.codec.decode([p.copy() for p in parts], meta))
            view += approx  # the shard's own copy
            entries.append(
                (
                    {
                        "name": name,
                        "codec": self.codec.name,
                        "meta": meta,
                        "delta": True,
                        "pdtype": compress_mod.dtype_str(arr.dtype),
                    },
                    parts,
                )
            )
        return entries


class ParamServerShard(object):
    """One PS shard: parameter store, optimizer and TCP service.

    A thread per connection; updates serialized under a lock (each push
    is one atomic read-modify-write, the async-SGD consistency model).
    A push whose header carries ``pod``/``window`` is applied at most
    once per (pod, window) (``applied_windows``, ``applied_log``).
    """

    def __init__(self):
        self._params = {}
        self._opt = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sock = None
        self.addr = None
        self.applied_windows = {}
        self.applied_log = []

    # -- ops -----------------------------------------------------------

    def _op_init(self, header, tensors):
        with self._lock:
            if self._opt is None:
                self._opt = _build_optimizer(header["optimizer"])
                self._params = {k: v.copy() for k, v in tensors.items()}
                logger.info(
                    "ps shard initialized: %d tensors, optimizer %s",
                    len(tensors),
                    header["optimizer"][0],
                )
            # idempotent: late initializers get the live params
            return {"op": "init_ok"}, dict(self._params)

    def _op_pull(self, header, tensors):
        with self._lock:
            return {"op": "pull_ok"}, dict(self._params)

    def _op_push(self, header, tensors):
        with self._lock:
            if self._opt is None:
                return {"op": "error", "error": "shard not initialized"}, {}
            pod, window = header.get("pod"), header.get("window")
            if pod is not None and window is not None:
                window = int(window)
                if window <= self.applied_windows.get(pod, -1):
                    # a re-pushed window: not applied again; the live
                    # params still answer it
                    return {"op": "push_ok", "dedup": True}, dict(
                        self._params
                    )
                self.applied_windows[pod] = window
                self.applied_log.append((pod, window))
            for name, grad in tensors.items():
                p = self._params.get(name)
                if p is None:
                    return {
                        "op": "error",
                        "error": "unknown tensor {0}".format(name),
                    }, {}
                self._params[name] = _apply_update(self._opt, name, p, grad)
            # fresh params piggyback on the push: one round trip
            return {"op": "push_ok"}, dict(self._params)

    def _op_window(self, header, tensors):
        """The last applied window for ``pod`` (-1 if it never pushed)."""
        with self._lock:
            return {
                "op": "window_ok",
                "last": self.applied_windows.get(header.get("pod"), -1),
            }, {}

    # -- service loop --------------------------------------------------

    def start(self, host="", port=0):
        """Bind and serve in background threads; returns ``(host, port)``."""
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.addr = self._sock.getsockname()
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="ps-accept")
        t.start()
        return self.addr

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="ps-conn").start()

    def _serve_conn(self, conn):
        ops = {"init": self._op_init, "pull": self._op_pull,
               "push": self._op_push, "window": self._op_window}
        reply = _ReplyCompressor()
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stop.is_set():
                try:
                    header, tensors = recv_msg(conn)
                except (ConnectionError, OSError, json.JSONDecodeError):
                    return
                op = header.get("op")
                if op == "stop":
                    send_msg(conn, {"op": "stop_ok"})
                    self.stop()
                    return
                if op == "codec":
                    try:
                        reply.negotiate(header.get("reply"))
                    except (ValueError, TypeError) as e:
                        send_msg(conn, {"op": "error", "error": str(e)})
                        continue
                    send_msg(conn, {
                        "op": "codec_ok",
                        "reply": reply.codec.name if reply.codec else None,
                    })
                    continue
                handler = ops.get(op)
                if handler is None:
                    send_msg(conn, {"op": "error", "error": "bad op " + repr(op)})
                    continue
                out_header, out_tensors = handler(header, tensors)
                if reply.codec is not None and out_tensors:
                    _send_frame(conn, out_header, reply.entries(out_tensors))
                else:
                    send_msg(conn, out_header, out_tensors)
        finally:
            conn.close()

    def stop(self):
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def join(self, timeout=None):
        """Block until the shard is stopped (the ``server.join()`` role)."""
        self._stop.wait(timeout)


def run_server(ctx, host=""):
    """Run this ps node's shard until a ``stop`` op or the process ends.

    Called from ``main_fun`` when ``ctx.job_name == "ps"``; the shard
    binds the port the cluster spec gives this ps task, so workers find
    it at ``ctx.cluster_spec["ps"][task_index]``.
    """
    addr = ctx.cluster_spec["ps"][ctx.task_index]
    port = int(addr.rsplit(":", 1)[1])
    shard = ParamServerShard()
    shard.start(host, port)
    logger.info("ps shard %d serving at %s", ctx.task_index, shard.addr)
    shard.join()


# ----------------------------------------------------------------------
# host trees
# ----------------------------------------------------------------------


def _host_leaf(x):
    """A leaf as a host numpy array (a tensor is copied off its device)."""
    if hasattr(x, "detach"):  # a torch tensor
        return compress_mod.to_numpy(x.detach().cpu())
    return np.asarray(x)


def _tree_flatten(tree):
    """``(leaves, treedef)`` without touching the leaves: dicts in sorted
    key order, lists and tuples in order, as ``jax.tree_util`` orders
    them."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            return (dict, keys, [walk(t[k]) for k in keys])
        if isinstance(t, (list, tuple)):
            return (type(t), None, [walk(v) for v in t])
        leaves.append(t)
        return None

    return leaves, walk(tree)


def _flatten(tree):
    """``(host numpy leaves, treedef)`` of a tree."""
    leaves, treedef = _tree_flatten(tree)
    return [_host_leaf(x) for x in leaves], treedef


def _unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, children = d
        vals = [build(c) for c in children]
        if kind is dict:
            return dict(zip(keys, vals))
        return kind(vals)

    return build(treedef)


class _PushHandle(object):
    """An in-flight push_pull: ``result()`` waits for every shard's reply
    and returns the unsharded params."""

    def __init__(self, client, boxes, events):
        self._client = client
        self._boxes = boxes
        self._events = events

    def result(self):
        return self._client._unshard(
            PSClient._collect(self._boxes, self._events)
        )


class PSClient(object):
    """The worker's connection to every PS shard.

    Args:
      addresses: ``"host:port"`` list (``ctx.cluster_spec["ps"]``).
      timeout: per-socket timeout and connect deadline, seconds.
      codec: gradient-push codec spec (``"int8"``, ``("topk", {"ratio":
        0.01})`` or a :class:`~..compress.Codec`); ``init`` ships exact.
      error_feedback: wrap a lossy push codec in
        :class:`~..compress.ErrorFeedback`.
      reply_codec: reply codec negotiated with every shard; parameter
        replies then arrive as compressed deltas against this client's
        view.  ``"same"`` reuses ``codec``'s spec.  If a shard rejects
        it, every shard goes back to dense replies (logged).
    """

    def __init__(self, addresses, timeout=60, codec=None,
                 error_feedback=True, reply_codec=None):
        from .. import telemetry
        from ..utils.retry import retry_call

        self.addresses = list(addresses)
        self._socks = []
        for a in self.addresses:
            host, _, port = a.rpartition(":")
            # backoff under a deadline: workers race the shards' startup
            s = retry_call(
                lambda h=host, p=int(port): socket.create_connection(
                    (h, p), timeout=max(1.0, timeout)
                ),
                "connect to ps shard at {0}".format(a),
                exceptions=(OSError,),
                deadline=timeout,
                base=0.2,
                max_delay=2.0,
            )
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks.append(s)
        self._treedef = None
        self._assignment = None  # leaf index -> shard index
        self._shapes = None
        push = compress_mod.get_codec(codec)
        if push is not None and isinstance(push, compress_mod.NoneCodec):
            push = None
        if push is not None and error_feedback:
            push = compress_mod.ErrorFeedback(push)
        self._push_codec = push
        if reply_codec == "same":
            reply_codec = push.spec() if push is not None else None
        self._reply_views = [dict() for _ in self._socks]
        self._reply_dtypes = [dict() for _ in self._socks]
        self._reply_active = False
        #: wire bytes laid on / pulled off each shard connection (one
        #: writer per index), counted from the reply negotiation on
        self._sent_bytes = [0] * len(self._socks)
        self._recv_bytes = [0] * len(self._socks)
        if reply_codec is not None:
            self._negotiate_reply(reply_codec)
        reg = telemetry.get_registry()
        self._m_bytes = reg.counter("ps.bytes_sent")
        self._m_bytes_recv = reg.counter("ps.bytes_recv")
        self._m_trips = reg.counter("ps.round_trips")
        self._m_rt_hist = reg.histogram("ps.round_trip_sec")
        self._tracer = telemetry.get_tracer()
        # persistent per-shard request workers: a round trip costs two
        # queue handoffs, not a thread spawn per shard per step
        self._reqs = [_queue_mod.Queue() for _ in self._socks]
        self._workers = []
        self._closed = False
        for i in range(len(self._socks)):
            t = threading.Thread(target=self._shard_worker, args=(i,),
                                 daemon=True, name="ps-shard-%d" % i)
            t.start()
            self._workers.append(t)

    def _negotiate_reply(self, spec):
        """Negotiate compressed-delta replies on every shard connection
        (before the workers start, so the sockets are free)."""
        spec = compress_mod.get_codec(spec).spec()
        ok = True
        for i, s in enumerate(self._socks):
            self._sent_bytes[i] += send_msg(s, {"op": "codec", "reply": spec})
            h, _ = recv_msg(s)
            self._recv_bytes[i] += h.get("_recv_nbytes", 0)
            if h.get("op") != "codec_ok":
                ok = False
        if not ok:
            logger.warning(
                "reply codec %s rejected by a shard; dense replies", spec
            )
            for i, s in enumerate(self._socks):
                self._sent_bytes[i] += send_msg(
                    s, {"op": "codec", "reply": None}
                )
                h, _ = recv_msg(s)
                self._recv_bytes[i] += h.get("_recv_nbytes", 0)
        self._reply_active = ok

    @property
    def bytes_sent(self):
        """Wire bytes laid on the shard connections (headers and
        payloads)."""
        return sum(self._sent_bytes)

    @property
    def bytes_recv(self):
        """Wire bytes pulled off the shard connections (headers and
        payloads): the reply traffic, which delta replies shrink."""
        return sum(self._recv_bytes)

    def _apply_reply(self, i, header, tensors):
        """Fold delta-coded tensors into this client's float32 view (the
        arithmetic the shard's ``_ReplyCompressor`` ran on its copy);
        dense tensors refresh the view."""
        if not self._reply_active:
            return tensors
        view = self._reply_views[i]
        dtypes = self._reply_dtypes[i]
        for m in header.get("tensors", ()):
            name = m.get("name")
            if name is None:
                continue
            if m.get("delta"):
                base = view.get(name)
                if base is None:
                    raise RuntimeError(
                        "shard {0} sent a delta for {1} without a dense "
                        "base".format(i, name)
                    )
                fresh = base + compress_mod.widen(tensors[name])
                view[name] = fresh
                dtype = compress_mod.resolve_dtype(m.get("pdtype", "<f4"))
                if dtype.kind == "V":
                    # the reference's shard names a bf16 leaf by its
                    # '<V2' str: the dense base has its real dtype
                    dtype = dtypes.get(name, dtype)
                tensors[name] = compress_mod.narrow(fresh, dtype)
            else:
                view[name] = compress_mod.widen(tensors[name], copy=True)
                dtypes[name] = tensors[name].dtype
        return tensors

    def _shard_worker(self, i):
        sock = self._socks[i]
        q = self._reqs[i]
        while True:
            item = q.get()
            if item is None:
                return
            header, tensors, box, ev, codec = item
            try:
                op = header.get("op", "?")
                t0 = time.perf_counter()
                # "push": codec encode and send; "pull": the reply wait
                # and decode
                with self._tracer.span("ps.push", trace="ps", shard=i,
                                       op=op) as sp:
                    sent = send_msg(sock, header, tensors, codec=codec)
                    sp.set("bytes", sent)
                self._sent_bytes[i] += sent
                self._m_bytes.inc(sent)
                with self._tracer.span("ps.pull", trace="ps", shard=i, op=op):
                    h, t = recv_msg(sock)
                self._recv_bytes[i] += h.get("_recv_nbytes", 0)
                self._m_bytes_recv.inc(h.get("_recv_nbytes", 0))
                self._m_trips.inc()
                self._m_rt_hist.observe(time.perf_counter() - t0)
                if h.get("op") == "error":
                    box[1] = RuntimeError(
                        "ps shard {0}: {1}".format(i, h["error"])
                    )
                else:
                    box[0] = self._apply_reply(i, h, t)
                    box[2] = h
            except Exception as e:  # noqa: BLE001 - delivered to caller
                box[1] = e
            ev.set()

    # -- sharding ------------------------------------------------------
    #
    # Small leaves go whole to one shard (size-balanced greedy); a leaf
    # of at least _CHUNK_BYTES with enough rows is split row-wise into
    # one chunk per shard, so its bytes cross every shard connection at
    # once.  Exact for the leafwise optimizers.

    _CHUNK_BYTES = 1 << 18

    def _assign(self, leaves):
        """Deterministic chunk plan: per leaf either a shard index or the
        list of shard indices its row chunks land on."""
        n = len(self._socks)
        load = [0] * n
        plan = [None] * len(leaves)
        order = sorted(range(len(leaves)), key=lambda i: (-leaves[i].nbytes, i))
        for i in order:
            leaf = leaves[i]
            if (
                n > 1
                and leaf.nbytes >= self._CHUNK_BYTES
                and getattr(leaf, "shape", ())
                and leaf.shape[0] >= n
            ):
                plan[i] = list(range(n))
                for s in range(n):
                    load[s] += leaf.nbytes // n
            else:
                shard = min(range(n), key=lambda s: (load[s], s))
                plan[i] = shard
                load[shard] += max(1, leaf.nbytes)
        return plan

    @staticmethod
    def _chunk_bounds(rows, k):
        """``np.array_split``'s boundary rule, kept explicit so the push
        and the reassembly can never disagree."""
        base, extra = divmod(rows, k)
        bounds = [0]
        for j in range(k):
            bounds.append(bounds[-1] + base + (1 if j < extra else 0))
        return bounds

    def _shard_tensors(self, leaves):
        per_shard = [dict() for _ in self._socks]
        for i, leaf in enumerate(leaves):
            target = self._assignment[i]
            if isinstance(target, list):
                arr = np.asarray(leaf)
                bounds = self._chunk_bounds(arr.shape[0], len(target))
                for j, s in enumerate(target):
                    per_shard[s]["t{0}c{1}".format(i, j)] = arr[
                        bounds[j]:bounds[j + 1]
                    ]
            else:
                per_shard[target]["t{0}".format(i)] = leaf
        return per_shard

    def _unshard(self, replies):
        flat = {}
        for tensors in replies:
            flat.update(tensors)
        leaves = []
        for i, target in enumerate(self._assignment):
            if isinstance(target, list):
                chunks = [flat["t{0}c{1}".format(i, j)]
                          for j in range(len(target))]
                # concatenate drops the bf16 tag: view it again
                leaves.append(np.concatenate(chunks, axis=0).view(
                    chunks[0].dtype))
            else:
                leaves.append(flat["t{0}".format(i)])
        return _unflatten(self._treedef, leaves)

    # -- round trips ---------------------------------------------------

    def _enqueue_all(self, headers, per_shard_tensors, codec=None):
        """One request per shard to the persistent workers (all shards in
        flight at once); returns ``(boxes, events)``."""
        if self._closed:
            raise RuntimeError("PSClient is closed")
        boxes = []
        events = []
        for i in range(len(self._socks)):
            box = [None, None, None]  # [reply, error, reply header]
            ev = threading.Event()
            boxes.append(box)
            events.append(ev)
            self._reqs[i].put((headers[i], per_shard_tensors[i], box, ev,
                               codec))
        return boxes, events

    @staticmethod
    def _collect(boxes, events):
        for ev in events:
            ev.wait()
        errors = [(i, box[1]) for i, box in enumerate(boxes)
                  if box[1] is not None]
        if errors:
            raise RuntimeError(
                "PS round trip failed: "
                + "; ".join("shard {0}: {1}".format(i, e) for i, e in errors)
            )
        return [box[0] for box in boxes]

    def _roundtrip_all(self, headers, per_shard_tensors):
        return self._collect(*self._enqueue_all(headers, per_shard_tensors))

    def _require_init(self):
        if self._assignment is None:
            raise RuntimeError(
                "call init(params_template, optimizer) before pull()/"
                "push_pull(): it defines the leaf->shard assignment "
                "(idempotent; the template does not overwrite live params)"
            )

    def init(self, params, optimizer=("sgd", {"learning_rate": 0.01})):
        """Initialize (or join) the PS ensemble; returns the live params.
        The first ``init`` seeds the shards, later ones receive the
        current values."""
        leaves, self._treedef = _flatten(params)
        self._shapes = [x.shape for x in leaves]
        self._assignment = self._assign(leaves)
        per_shard = self._shard_tensors(leaves)
        headers = [
            {"op": "init", "optimizer": [optimizer[0], optimizer[1] or {}]}
            for _ in self._socks
        ]
        return self._unshard(self._roundtrip_all(headers, per_shard))

    def pull(self):
        """The current params of every shard (after :meth:`init`)."""
        self._require_init()
        headers = [{"op": "pull"} for _ in self._socks]
        return self._unshard(self._roundtrip_all(headers,
                                                 [{}] * len(self._socks)))

    def push_pull(self, grads, header_extra=None):
        """Ship gradients, get fresh params back (one async-SGD step)."""
        return self.push_pull_async(grads, header_extra=header_extra).result()

    def push_pull_async(self, grads, header_extra=None):
        """Enqueue the push on every shard worker and return a handle
        whose ``result()`` waits for the replies and unshards them.
        ``header_extra`` merges JSON-able fields into every push header."""
        self._require_init()
        leaves, _ = _flatten(grads)
        per_shard = self._shard_tensors(leaves)
        headers = [dict({"op": "push"}, **(header_extra or {}))
                   for _ in self._socks]
        return _PushHandle(
            self, *self._enqueue_all(headers, per_shard,
                                     codec=self._push_codec))

    def window_floor(self, pod):
        """The highest window every shard has applied for ``pod`` (-1
        when it never pushed)."""
        headers = [{"op": "window", "pod": pod} for _ in self._socks]
        boxes, events = self._enqueue_all(headers, [{}] * len(self._socks))
        self._collect(boxes, events)
        return min(int((b[2] or {}).get("last", -1)) for b in boxes)

    def _join_workers(self):
        self._closed = True
        for q in self._reqs:
            q.put(None)
        for t in self._workers:
            t.join(timeout=5)
        self._workers = []

    def stop(self):
        """Stop every shard (the end of training; the driver's control
        queue release is the backstop)."""
        self._join_workers()  # no reader in flight on the sockets
        for s in self._socks:
            try:
                send_msg(s, {"op": "stop"})
                recv_msg(s)
            except (ConnectionError, OSError):
                pass
        self.close()

    def close(self):
        if self._workers:
            self._join_workers()
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass


# ----------------------------------------------------------------------
# the worker's trainer
# ----------------------------------------------------------------------


class _HostBuffers(object):
    """Two alternating sets of host buffers for gradient readbacks
    (pinned on a CUDA device), so window N+1 is read back while window
    N's bytes are still on the wire.  A set is keyed by leaf index and
    reallocated when a leaf's shape or dtype changes."""

    def __init__(self, pinned):
        self._pinned = pinned
        self._sets = [[], []]
        self._next = 0

    def take(self, tensors):
        import torch

        bufs = self._sets[self._next]
        self._next ^= 1
        if [(b.shape, b.dtype) for b in bufs] != [
                (t.shape, t.dtype) for t in tensors]:
            bufs[:] = [torch.empty(t.shape, dtype=t.dtype,
                                   pin_memory=self._pinned) for t in tensors]
        return bufs


def _torch_dtype(np_dtype):
    """The ``torch`` dtype of a host leaf's numpy dtype."""
    return compress_mod.to_torch(np.empty(0, np_dtype)).dtype


def _readback(tensors, bufs, event=None, stream=None):
    """Copy device ``tensors`` into host ``bufs``.  On a CUDA device the
    copy runs on ``stream`` after ``event`` (recorded where the tensors
    were produced) and only that copy is waited for; the caller keeps the
    device tensors alive until this returns."""
    import torch

    if stream is None:
        for b, t in zip(bufs, tensors):
            b.copy_(t.detach(), non_blocking=True)
        if tensors and tensors[0].is_cuda:
            torch.cuda.current_stream(tensors[0].device).synchronize()
        return
    with torch.cuda.stream(stream):
        stream.wait_event(event)
        for b, t in zip(bufs, tensors):
            b.copy_(t.detach(), non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()


class _GradDrain(object):
    """Background device-to-host gradient drain feeding the push pipeline.

    The training thread hands over device gradients with a CUDA event
    recorded after the window's last gradient op, and goes on
    dispatching; this thread copies them on a side stream that waits on
    that event (so the next step's work on the default stream is not
    waited for) into pinned buffers, and enqueues the push.  The
    readback of window N+1 overlaps the round trip of window N.
    ``max_inflight`` bounds the windows queued or in flight.
    """

    _STOP = object()

    def __init__(self, client, max_inflight=2, device=None, on_readback=None):
        import torch

        self._client = client
        self._device = device
        self._cuda = device is not None and device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if self._cuda else None
        self._bufs = _HostBuffers(self._cuda)
        self._on_readback = on_readback
        self._slots = threading.Semaphore(max(1, int(max_inflight)))
        self._q = _queue_mod.Queue()
        self._fresh_lock = threading.Lock()
        self._fresh = None
        self._fresh_seq = 0
        self._error = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ps-grad-drain")
        self._thread.start()

    def _to_host(self, item):
        """Read one window back on this thread; returns its host leaves
        (numpy views of the pinned buffers)."""
        from .. import telemetry

        tensors, event = item
        t0 = time.perf_counter()
        bufs = self._bufs.take(tensors)
        _readback(tensors, bufs, event, self._stream)
        dur = time.perf_counter() - t0
        telemetry.get_registry().histogram(
            "ps.grad_readback_sec").observe(dur)
        telemetry.get_tracer().add("grad_readback", t0, dur, trace="ps")
        if self._on_readback is not None:
            self._on_readback(dur)
        return [compress_mod.to_numpy(b) for b in bufs]

    def submit(self, device_grads):
        """Hand a window of device gradients (a list of tensors) to the
        drain; blocks only while ``max_inflight`` windows are out.  Raises
        an error a previous window hit (once)."""
        import torch

        self._raise_pending()
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self._device))
        # released by the drain thread once the window's round trip lands
        self._slots.acquire()
        self._q.put((list(device_grads), event))

    def freshest(self):
        """``(seq, params)`` of the latest landed round trip (params None
        before the first)."""
        self._raise_pending()
        with self._fresh_lock:
            return self._fresh_seq, self._fresh

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _land(self, handle):
        try:
            fresh = handle.result()
            with self._fresh_lock:
                self._fresh = fresh
                self._fresh_seq += 1
        except Exception as e:  # noqa: BLE001 - surfaced on next submit
            if self._error is None:
                self._error = e
        finally:
            self._slots.release()

    def _loop(self):
        prev = None
        while True:
            item = self._q.get()
            if item is self._STOP:
                break
            if isinstance(item, threading.Event):  # flush marker
                if prev is not None:
                    self._land(prev)
                    prev = None
                item.set()
                continue
            try:
                host = self._to_host(item)
                item = None  # the device tensors may go now
                handle = self._client.push_pull_async(host)
            except Exception as e:  # noqa: BLE001 - surfaced on submit
                if self._error is None:
                    self._error = e
                self._slots.release()
                continue
            # land the PREVIOUS round trip only now: its wire time
            # overlapped this window's readback
            if prev is not None:
                self._land(prev)
            prev = handle
        if prev is not None:
            self._land(prev)

    def flush(self):
        """Block until every submitted window has landed; returns
        ``(seq, params)`` of the freshest."""
        ev = threading.Event()
        self._q.put(ev)
        ev.wait()
        return self.freshest()

    def stop(self):
        self._q.put(self._STOP)
        self._thread.join(timeout=10)


class AsyncTrainer(object):
    """Async-PS worker loop: gradients on this node's device, updates on
    the parameter hosts.

    Args:
      loss_fn: ``loss_fn(params, batch) -> scalar tensor``; ``params`` is
        the parameter tree (a ``{name: tensor}`` dict, say) on the
        trainer's device, ``batch`` whatever :meth:`step` is given.
      ps_addresses: ``ctx.cluster_spec["ps"]``.
      optimizer: named spec, e.g. ``("adam", {"learning_rate": 1e-3})``.
      pipeline: overlap the round trip with the next gradient
        computation; a step then trains on params one round trip staler.
      overlap: read the gradients back on a background thread
        (:class:`_GradDrain`), off the training loop; staleness bounded
        by ``max_inflight`` windows.
      push_every: average this many steps' gradients on the device per
        push.
      max_inflight: the staleness bound of ``overlap``.
      codec / reply_codec / error_feedback: gradient-plane compression,
        forwarded to :class:`PSClient`.
      topology: ``"flat"``; ``"hierarchical"`` is not ported.
      device: where gradients are computed and the returned params live
        (default ``cuda``; ``"cpu"`` on request).

    The gradients are ``torch.autograd.grad`` over leaf copies of the
    params (the flash attention function is an old-style
    ``autograd.Function``, which ``torch.func.grad`` cannot take).  A
    reply is copied onto the device from reused pinned buffers with
    ``non_blocking`` copies on the current stream, ahead of the next
    gradient that reads it.  ``last_loss`` is the last step's loss (a
    device scalar); ``readback_sec`` and :meth:`h2d_ms` time the
    readbacks and the reply copies.
    """

    def __init__(self, loss_fn, ps_addresses,
                 optimizer=("sgd", {"learning_rate": 0.01}),
                 pipeline=True, overlap=False, push_every=1,
                 max_inflight=2, codec=None, reply_codec=None,
                 error_feedback=True, topology="flat", mesh=None,
                 pod_id="pod0", members=None, member_id=0,
                 leader_fn=None, device=None):
        import torch

        from ..compat import resolve_device

        if push_every < 1:
            raise ValueError(
                "push_every must be >= 1, got {0}".format(push_every)
            )
        if topology not in ("flat", "hierarchical"):
            raise ValueError(
                "topology must be 'flat' or 'hierarchical', got "
                "{0!r}".format(topology)
            )
        if topology == "hierarchical":
            raise _not_ported("AsyncTrainer(topology='hierarchical')",
                              "A14, hier_ps (parallel/hier_ps.py)")
        del mesh, pod_id, members, member_id, leader_fn
        self.topology = topology
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._client = PSClient(
            ps_addresses, codec=codec, reply_codec=reply_codec,
            error_feedback=error_feedback,
        )
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.pipeline = pipeline
        self.overlap = bool(overlap)
        self.push_every = int(push_every)
        self._inflight = None
        self._accum = None
        self._accum_n = 0
        self.last_loss = None
        #: seconds of each gradient readback (either thread)
        self.readback_sec = []
        self._h2d_ms = []
        self._h2d_pending = None  # (start, end) events of the last copy
        self._h2d_bufs = []
        self._read_bufs = _HostBuffers(self._cuda)
        self._fresh_seq = 0
        self._fresh_params = None
        self._drain = (
            _GradDrain(self._client, max_inflight=max_inflight,
                       device=self.device,
                       on_readback=self.readback_sec.append)
            if self.overlap else None
        )
        self._torch = torch

    @property
    def client(self):
        """The live :class:`PSClient` (wire accounting)."""
        return self._client

    def init(self, params):
        """Initialize (or join) the shards with ``params``; returns the
        live params on the trainer's device."""
        return self._to_device(self.client.init(params, self.optimizer))

    # -- device side ---------------------------------------------------

    def _grads(self, params, batch):
        leaves, treedef = _tree_flatten(params)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        loss = self.loss_fn(_unflatten(treedef, leaves), batch)
        grads = self._torch.autograd.grad(loss, leaves)
        self.last_loss = loss.detach()
        return list(grads)

    def _mean(self, acc, n):
        inv = 1.0 / float(n)
        return [a * inv for a in acc]

    def _accumulate(self, grads):
        """Fold one step's device grads into the window; returns the mean
        window to ship, or None while it fills (no host sync here)."""
        if self.push_every == 1:
            return grads
        self._accum = (grads if self._accum is None
                       else [a + g for a, g in zip(self._accum, grads)])
        self._accum_n += 1
        if self._accum_n < self.push_every:
            return None
        out = self._mean(self._accum, self._accum_n)
        self._accum, self._accum_n = None, 0
        return out

    def _to_host(self, window):
        """The blocking readback on the training thread: the window's
        gradients as host leaves in the params' leaf order (numpy views
        of pinned buffers)."""
        from .. import telemetry

        t0 = time.perf_counter()
        bufs = self._read_bufs.take(window)
        _readback(window, bufs)
        dur = time.perf_counter() - t0
        telemetry.get_registry().histogram(
            "ps.grad_readback_sec").observe(dur)
        self.readback_sec.append(dur)
        return [compress_mod.to_numpy(b) for b in bufs]

    def _to_device(self, host_tree):
        """A reply (host tree) as tensors on the trainer's device: each
        leaf staged in its reused pinned buffer, then copied with
        ``non_blocking`` on the current stream; the next staging waits
        for the previous copies' event first."""
        torch = self._torch
        leaves, treedef = _flatten(host_tree)
        if not self._cuda:
            return _unflatten(treedef, [compress_mod.to_torch(x.copy())
                                        for x in leaves])
        self._settle_h2d()
        bufs = self._h2d_bufs
        want = [(x.shape, _torch_dtype(x.dtype)) for x in leaves]
        if [(tuple(b.shape), b.dtype) for b in bufs] != want:
            bufs[:] = [torch.empty(shape, dtype=dtype, pin_memory=True)
                       for shape, dtype in want]
        for b, x in zip(bufs, leaves):
            compress_mod.to_numpy(b)[...] = x
        stream = torch.cuda.current_stream(self.device)
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = [b.to(self.device, non_blocking=True) for b in bufs]
        end.record(stream)
        self._h2d_pending = (start, end)
        return _unflatten(treedef, out)

    def _settle_h2d(self):
        """Wait for the last reply's copy (its pinned buffers are about to
        be reused) and keep its device time."""
        if self._h2d_pending is not None:
            start, end = self._h2d_pending
            end.synchronize()
            self._h2d_ms.append(start.elapsed_time(end))
            self._h2d_pending = None

    def h2d_ms(self):
        """Device milliseconds of each reply's copy onto the device (waits
        for the last; empty on the CPU)."""
        self._settle_h2d()
        return list(self._h2d_ms)

    # -- steps ---------------------------------------------------------

    def step(self, params, batch):
        """One async step; returns fresh params on the device (gradients
        computed at ``params`` may land after other workers')."""
        window = self._accumulate(self._grads(params, batch))
        if window is None:
            return self._freshest(params)
        if self.overlap:
            # the DEVICE tensors go to the drain: the readback happens on
            # its thread, this one goes straight back to dispatching
            self._drain.submit(window)
            return self._freshest(params)
        host = self._to_host(window)
        if not self.pipeline:
            return self._to_device(self.client.push_pull(host))
        # enqueue this push, then collect the PREVIOUS round trip, whose
        # wire time overlapped this step's gradients; the new handle
        # replaces _inflight first, so a failed trip raises once
        prev, self._inflight = self._inflight, self.client.push_pull_async(
            host)
        return self._to_device(prev.result()) if prev is not None else params

    def _freshest(self, params):
        if self._drain is None:
            return params
        seq, fresh = self._drain.freshest()
        return self._adopt_fresh(seq, fresh, params)

    def _adopt_fresh(self, seq, fresh, params):
        """Copy the drain's freshest params onto the device once per
        landed round trip."""
        if fresh is None:
            return params
        if seq != self._fresh_seq:
            self._fresh_seq = seq
            self._fresh_params = self._to_device(fresh)
        return self._fresh_params

    def drain(self):
        """Block until every in-flight round trip lands; returns the
        freshest params on the device, or None.  A partly filled window
        is shipped as the mean over its actual count."""
        if self._accum is not None:
            window = self._mean(self._accum, self._accum_n)
            self._accum, self._accum_n = None, 0
            if self._drain is not None:
                self._drain.submit(window)
            else:
                prev, self._inflight = self._inflight, None
                if prev is not None:
                    prev.result()
                return self._to_device(self.client.push_pull(
                    self._to_host(window)))
        if self._drain is not None:
            seq, fresh = self._drain.flush()
            return self._adopt_fresh(seq, fresh, None)
        if self._inflight is None:
            return None
        fresh = self._inflight.result()
        self._inflight = None
        return self._to_device(fresh)

    def stop(self, stop_servers=False):
        """Drain, stop the drain thread, and close the client (stopping
        the shards too with ``stop_servers``)."""
        try:
            self.drain()
        except Exception:  # noqa: BLE001 - teardown must proceed
            logger.warning("drain at stop failed", exc_info=True)
        if self._drain is not None:
            self._drain.stop()
        if stop_servers:
            self.client.stop()
        else:
            self.client.close()

