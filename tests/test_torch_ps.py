"""The port's parameter-server plane (``tensorflowonspark_tpu_torch/
parallel/ps.py``) held to the JAX package's ``parallel/ps.py`` on the CPU:

- frames written by the port's ``send_msg`` equal the reference's byte
  for byte over a ``socketpair`` (plain, codec-carrying and bf16
  entries), and every ``recv_msg`` rejection raises the reference's
  error type and text;
- the shard's numpy optimizers give the reference's updates to the bit;
- the wire both ways: the port's client against the reference's shards
  and the reference's client against the port's, with int8 and top-k
  pushes, delta replies and a bf16 leaf, reply for reply equal to the
  reference against itself; the same leaf names and size-balanced
  assignment for the same leaf list;
- ``AsyncTrainer(device="cpu")`` on ``MNISTNet`` (converted from the
  Flax tree) against the reference's ``AsyncTrainer`` on the same
  batches: the shards' parameters after 8 steps within 1e-5 (norm of the
  difference over the norm, per leaf) for ``pipeline`` False and True and
  ``push_every=2``, and for int8 pushes under error feedback the params
  less ``lr`` x the residual (see the test);
- ``overlap`` pushes once per window, ``drain`` surfaces a background
  error, ``bytes_recv`` equals the ``ps.bytes_recv`` counter, and
  ``topology="hierarchical"`` raises naming ``hier_ps``.

Plus the reference's fault that the port repairs: a delta reply on a
bf16 leaf names it ``'<V2'``, which the reference's client casts to raw
void bytes.
"""

import json
import socket
import struct
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import compress as jc
from tensorflowonspark_tpu.parallel import ps as jps
from tensorflowonspark_tpu_torch import compress as tc
from tensorflowonspark_tpu_torch import telemetry
from tensorflowonspark_tpu_torch.parallel import ps as tps

TRAJ_RTOL = 1e-5


def _shards(mod, n):
    shards = [mod.ParamServerShard() for _ in range(n)]
    addrs = ["127.0.0.1:{0}".format(s.start("127.0.0.1", 0)[1])
             for s in shards]
    return shards, addrs


@pytest.fixture()
def two_shards():
    shards, addrs = _shards(tps, 2)
    yield addrs
    for s in shards:
        s.stop()


def _bf16_pair(f):
    """The same bf16 values as ``(ml_dtypes array, port bits)``."""
    j = np.asarray(np.asarray(f, np.float32).astype(ml_dtypes.bfloat16))
    return j, np.asarray(j.view(np.uint16)).view(tc.BFLOAT16)


def _bits(a):
    a = np.ascontiguousarray(a)
    bf = a.dtype == ml_dtypes.bfloat16 or tc.is_bf16(a.dtype)
    return ("bfloat16" if bf else a.dtype.str), a.shape, a.tobytes()


def _same_tree(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


# --- framing ------------------------------------------------------------


def _frame_bytes(mod, header, tensors, codec=None):
    a, b = socket.socketpair()
    try:
        n = mod.send_msg(a, header, tensors, codec=codec)
        return n, jps._recv_exact(b, n)
    finally:
        a.close()
        b.close()


FRAME_CASES = ["plain", "int8", "topk", "int8_ef", "bf16", "bf16_int8"]


@pytest.mark.parametrize("case", FRAME_CASES)
def test_frames_equal_the_reference_byte_for_byte(case):
    rng = np.random.RandomState(FRAME_CASES.index(case))
    f = {"x": rng.randn(40, 30).astype(np.float32),
         "y": np.arange(7, dtype=np.int64),
         "empty": np.zeros((0,), np.float32),
         "s": np.asarray(np.float32(2.5))}
    jt, tt = dict(f), dict(f)
    if case.startswith("bf16"):
        for k in ("x", "s"):
            jt[k], tt[k] = _bf16_pair(f[k])
    codec = {"plain": None, "bf16": None, "int8": "int8",
             "bf16_int8": "int8", "topk": ("topk", {"ratio": 0.1,
                                                   "min_size": 4}),
             "int8_ef": "int8"}[case]
    jcod, tcod = jc.get_codec(codec), tc.get_codec(codec)
    if case == "int8_ef":
        jcod, tcod = jc.ErrorFeedback(jcod), tc.ErrorFeedback(tcod)
    if case == "int8_ef":
        for _ in range(3):  # a residual carried into the compared frame
            _frame_bytes(jps, {"op": "push"}, jt, jcod)
            _frame_bytes(tps, {"op": "push"}, tt, tcod)
    if codec is not None:
        jt.pop("empty"), tt.pop("empty")  # the codecs need data
    header = {"op": "push", "k": 1, "pod": "p0", "window": 3}
    want = _frame_bytes(jps, header, jt, jcod)
    got = _frame_bytes(tps, header, tt, tcod)
    assert got == want
    # and the port decodes the reference's frame as the reference does
    a, b = socket.socketpair()
    try:
        a.sendall(want[1])
        th, tg = tps.recv_msg(b)
        a.sendall(want[1])
        jh, jg = jps.recv_msg(b)
    finally:
        a.close()
        b.close()
    assert th == jh and th["_recv_nbytes"] == want[0]
    _same_tree(tg, jg)


def _rejection(mod, raw):
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        a.shutdown(socket.SHUT_WR)
        with pytest.raises(Exception) as err:
            mod.recv_msg(b)
        return type(err.value), str(err.value)
    finally:
        a.close()
        b.close()


def _hdr(obj):
    hb = json.dumps(obj).encode()
    return struct.pack(">I", len(hb)) + hb


REJECTIONS = {
    "truncated": _hdr({"op": "push", "tensors": [
        {"name": "x", "dtype": "<f4", "shape": [4], "nbytes": 16}]})
    + b"\0" * 7,
    "garbage_header": struct.pack(">I", 5) + b"\xff{not",
    "not_an_object": _hdr([1, 2]),
    "oversized_header": struct.pack(">I", tps._MAX_HEADER + 1),
    "inconsistent_meta": _hdr({"op": "push", "tensors": [
        {"name": "x", "dtype": "<f4", "shape": [4], "nbytes": 12}]}),
    "bad_meta": _hdr({"op": "push", "tensors": [
        {"name": "x", "dtype": "<f4", "shape": ["q"], "nbytes": 4}]}),
    "unknown_codec": _hdr({"op": "push", "tensors": [
        {"name": "x", "codec": "evil", "meta": {}, "parts": []}]}),
    "bad_codec_meta": _hdr({"op": "push", "tensors": [
        {"name": "x", "codec": "int8", "meta": {}, "parts": [
            {"dtype": "|i1", "shape": [2], "nbytes": 2}]}]}) + b"\1\2",
    "midframe_close": struct.pack(">I", 100) + b"{",
}


@pytest.mark.parametrize("name", sorted(REJECTIONS))
def test_recv_msg_rejections_match_the_reference(name):
    assert _rejection(tps, REJECTIONS[name]) == \
        _rejection(jps, REJECTIONS[name])


# --- the shard's optimizers --------------------------------------------


@pytest.mark.parametrize("spec", [
    ("sgd", {"learning_rate": 0.05}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("adagrad", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 1e-3}),
    ("adam", {}),
    ("delta", {"scale": 0.5}),
], ids=["sgd", "momentum", "adagrad", "adam", "adam_default", "delta"])
def test_optimizers_equal_the_reference_to_the_bit(spec):
    rng = np.random.RandomState(0)
    jo, to = jps._build_optimizer(spec), tps._build_optimizer(spec)
    jp = tp = rng.randn(64, 9).astype(np.float32)
    for _ in range(6):
        g = rng.randn(64, 9).astype(np.float32)
        jp = jo.update("w", jp, g)
        tp = to.update("w", tp, g)
        assert tp.dtype == jp.dtype and tp.tobytes() == jp.tobytes()
    with pytest.raises(ValueError) as want:
        jps._build_optimizer(("magic", {}))
    with pytest.raises(ValueError) as got:
        tps._build_optimizer(("magic", {}))
    assert str(got.value) == str(want.value)


# --- the wire, both ways ------------------------------------------------


def _params(rng):
    p = {"big": rng.randn(600, 130).astype(np.float32),  # row-chunked
         "w": rng.randn(40, 8).astype(np.float32),
         "b": rng.randn(8).astype(np.float32),
         "h": rng.randn(300).astype(np.float32)}
    return p


def _session(server, client, kw, bf16, seed=3):
    """init, three pushes and a pull of one client against two fresh
    shards; returns every reply as {name: bits}."""
    shards, addrs = _shards(server, 2)
    cmod_c = tc if client is tps else jc
    try:
        rng = np.random.RandomState(seed)
        p = _params(rng)
        if bf16:
            j, t = _bf16_pair(p["h"])
            p["h"] = t if client is tps else j
        c = client.PSClient(addrs, **kw)
        out = [c.init(p, ("sgd", {"learning_rate": 0.05}))]
        for _ in range(3):
            g = {k: (rng.randn(*np.shape(v)) * 0.1).astype(np.float32)
                 for k, v in _params(rng).items()}
            if bf16:
                j, t = _bf16_pair(g["h"])
                g["h"] = t if client is tps else j
            out.append(c.push_pull(g))
        out.append(c.pull())
        sent, recv = c.bytes_sent, c.bytes_recv
        c.close()
        del cmod_c
        return ([{k: _bits(v) for k, v in r.items()} for r in out],
                sent, recv)
    finally:
        for s in shards:
            s.stop()


WIRE_KW = {
    "dense": {},
    "int8": {"codec": "int8"},
    "int8_delta": {"codec": "int8", "reply_codec": "same"},
    "topk_delta": {"codec": ("topk", {"ratio": 0.05}),
                   "reply_codec": "int8"},
    "int8_no_ef": {"codec": "int8", "error_feedback": False},
}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kw", sorted(WIRE_KW))
def test_wire_interop_both_ways(kw, bf16):
    want = _session(jps, jps, WIRE_KW[kw], bf16)
    assert _session(jps, tps, WIRE_KW[kw], bf16) == want  # port client
    assert _session(tps, jps, WIRE_KW[kw], bf16) == want  # port shard
    assert _session(tps, tps, WIRE_KW[kw], bf16) == want


def test_leaf_names_and_assignment_equal_the_reference():
    rng = np.random.RandomState(0)
    leaves = [rng.randn(*s).astype(np.float32) for s in
              [(700, 100), (5,), (300, 300), (2, 40000), (64,), (1,), (90,)]]
    for n in (1, 2, 3):
        jcl = jps.PSClient.__new__(jps.PSClient)
        tcl = tps.PSClient.__new__(tps.PSClient)
        jcl._socks = tcl._socks = [None] * n
        jcl._assignment = jcl._assign(leaves)
        tcl._assignment = tcl._assign(leaves)
        assert tcl._assignment == jcl._assignment
        got = tcl._shard_tensors(leaves)
        want = jcl._shard_tensors(leaves)
        assert [sorted(d) for d in got] == [sorted(d) for d in want]
        for g, w in zip(got, want):
            for k in w:
                assert g[k].tobytes() == w[k].tobytes()
    assert tps.PSClient._chunk_bounds(10, 3) == jps.PSClient._chunk_bounds(
        10, 3) == [0, 4, 7, 10]


def test_reference_client_casts_a_bf16_delta_to_void():
    """The fault: with delta replies, a pull of a bf16 leaf that no push
    has promoted yet comes back to the reference's client as ``'<V2'``
    zeros from the reference's shard; from the port's shard it gets the
    bf16 values, and the port's client reads both shards right."""
    vals = np.linspace(-2, 2, 2000, dtype=np.float32)
    j, t = _bf16_pair(vals)
    got = {}
    for server in (jps, tps):
        for client, leaf in ((jps, j), (tps, t)):
            shards, addrs = _shards(server, 1)
            c = client.PSClient(addrs, codec="int8", reply_codec="same")
            c.init({"w": leaf}, ("sgd", {"learning_rate": 0.1}))
            got[server, client] = c.pull()["w"]
            c.close()
            shards[0].stop()
    bad = got[jps, jps]
    assert bad.dtype.kind == "V" and not bad.view(np.uint8).any()
    assert got[tps, jps].dtype == ml_dtypes.bfloat16
    assert got[tps, jps].tobytes() == j.tobytes()
    for server in (jps, tps):
        assert tc.is_bf16(got[server, tps].dtype)
        assert got[server, tps].tobytes() == j.tobytes()


# --- AsyncTrainer against the reference's -------------------------------

HIDDEN, BATCH, STEPS = 32, 16, 8


def _mnist_batches(n):
    rng = np.random.RandomState(7)
    x = rng.rand(n * BATCH, 784).astype(np.float32)
    y = rng.randint(0, 10, n * BATCH).astype(np.int64)
    return [{"image": x[i * BATCH:(i + 1) * BATCH],
             "label": y[i * BATCH:(i + 1) * BATCH]} for i in range(n)]


def _jax_run(addrs, kw, batches):
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models import mlp as jmlp

    model = jmlp.MNISTNet(hidden=HIDDEN)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 784)))["params"]

    def loss(params, batch):
        logits = model.apply({"params": params}, batch["image"])
        logp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(
            logp, batch["label"].astype(jnp.int32)[:, None], axis=-1)[:, 0]
        return jnp.mean(nll)

    tr = jps.AsyncTrainer(loss, addrs, **kw)
    p = tr.init(jax.tree_util.tree_map(np.asarray, params))
    for b in batches:
        p = tr.step(p, b)
    tr.drain()
    out = tr.client.pull()
    res = _compensation(tr, [np.asarray(x).shape for x in
                             jax.tree_util.tree_leaves(out)])
    tr.stop()
    return params, out, res


def _compensation(tr, shapes):
    """``lr`` x the error-feedback residual per leaf (flatten order),
    zeros without a codec: the shard holds ``init - lr * sum(decoded)``
    and the residual is ``sum(true) - sum(decoded)``, so ``params -
    lr * residual`` is ``init - lr * sum(true grads)``."""
    lr = tr.optimizer[1]["learning_rate"]
    codec = tr.client._push_codec
    if codec is None:
        return [np.zeros(s, np.float32) for s in shapes]
    return [lr * codec._residual["t{0}".format(i)].reshape(s)
            for i, s in enumerate(shapes)]


def _port_run(addrs, kw, batches, flax_params):
    from tensorflowonspark_tpu_torch.models import mlp as tmlp

    model = tmlp.MNISTNet(hidden=HIDDEN, device="cpu")
    tmlp.params_from_flax(jax_to_numpy(flax_params), model)
    lossf = tmlp.loss_fn(model)
    tr = tps.AsyncTrainer(lambda p, b: lossf(p, b, None)[0], addrs,
                          device="cpu", **kw)
    p = tr.init({k: v.detach() for k, v in model.named_parameters()})
    for b in batches:
        p = tr.step(p, {k: torch.from_numpy(v) for k, v in b.items()})
    tr.drain()
    out = tr.client.pull()
    res = _compensation(tr, [out[k].shape for k in sorted(out)])
    tr.stop()
    trees = []
    for shift in ([0.0] * len(res), res):
        with torch.no_grad():
            for k, r in zip(sorted(out), shift):
                model.get_parameter(k).copy_(
                    torch.from_numpy(np.array(out[k]) - r))
        trees.append(tmlp.tree_from_model(model)["params"])
    return trees


def jax_to_numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("kw,shards", [
    ({"pipeline": False}, 2),
    ({"pipeline": True}, 2),
    ({"pipeline": True, "push_every": 2}, 2),
    ({"pipeline": False, "codec": "int8"}, 1),
], ids=["unpipelined", "pipelined", "push_every2", "int8_ef"])
def test_async_trainer_trajectory_matches_the_reference(kw, shards):
    """Each package trains against its own fresh shards.  The int8 case
    runs one shard, since the two layouts chunk a large leaf into
    different row blocks (transposed kernels) and int8 scales are per
    chunk.  It compares the shards' params less ``lr`` x each client's
    error-feedback residual: an entry of ``x / scale`` within an ulp of
    a rounding tie quantizes one step apart in the two packages (their
    f32 gradients differ in the last bits), which moves the raw params by
    ``lr * scale`` there (1.8e-5 of the norm in a first run) but not this
    sum, where error feedback pays the step back."""
    kw = dict(kw, optimizer=("sgd", {"learning_rate": 0.1}))
    batches = _mnist_batches(STEPS)
    js, jaddrs = _shards(jps, shards)
    ts, taddrs = _shards(tps, shards)
    try:
        init, want, jres = _jax_run(jaddrs, kw, batches)
        raw, compensated = _port_run(taddrs, kw, batches, init)
    finally:
        for s in js + ts:
            s.stop()
    flat_w = jax_to_numpy(want)
    got = compensated if "codec" in kw else raw
    moved = 0.0
    leaves = [("dense1", "bias"), ("dense1", "kernel"), ("dense2", "bias"),
              ("dense2", "kernel")]  # flatten order
    for (layer, leaf), r in zip(leaves, jres):
        w = np.asarray(flat_w[layer][leaf]) - r
        g = got[layer][leaf]
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= TRAJ_RTOL, (layer, leaf, rel)
        moved += np.linalg.norm(w - np.asarray(init[layer][leaf]))
    assert moved > 1e-2  # the steps moved the weights


def test_overlap_pushes_once_per_window(two_shards):
    calls = []
    tr = tps.AsyncTrainer(lambda p, b: torch.sum(p["w"] ** 2), two_shards,
                          optimizer=("sgd", {"learning_rate": 0.01}),
                          overlap=True, push_every=5, device="cpu")
    orig = tr.client.push_pull_async
    tr.client.push_pull_async = lambda g: calls.append(1) or orig(g)
    p = tr.init({"w": torch.ones(4)})
    threads = set()
    orig_host = tr._drain._to_host

    def spy(item):
        threads.add(threading.current_thread().name)
        return orig_host(item)

    tr._drain._to_host = spy
    for _ in range(23):
        p = tr.step(p, None)
    drained = tr.drain()
    tr.stop(stop_servers=True)
    assert len(calls) == 5  # 4 full windows + the partial (3-step) one
    assert threads == {"ps-grad-drain"}  # never the training thread
    assert drained is not None and len(tr.readback_sec) == 5


def test_overlap_with_push_every_converges(two_shards):
    target = torch.tensor([2.0, -1.0, 0.25, -3.0])
    tr = tps.AsyncTrainer(lambda p, b: torch.sum((p["w"] - target) ** 2),
                          two_shards, optimizer=("sgd", {"learning_rate": 0.1}),
                          overlap=True, push_every=4, codec="int8",
                          reply_codec="same", device="cpu")
    p = tr.init({"w": torch.zeros(4)})
    for _ in range(402):  # a partial window that drain() must ship
        p = tr.step(p, None)
    drained = tr.drain()
    tr.stop(stop_servers=True)
    assert float((drained["w"] - target).abs().max()) < 2e-2


def test_drain_surfaces_background_errors(two_shards):
    tr = tps.AsyncTrainer(lambda p, b: torch.sum(p["w"] ** 2), two_shards,
                          optimizer=("sgd", {"learning_rate": 0.01}),
                          overlap=True, device="cpu")
    p = tr.init({"w": torch.ones(4)})
    tr.step(p, None)
    tr.client.close()  # the wire goes away under the drain
    with pytest.raises(RuntimeError, match="closed"):
        for _ in range(50):
            tr.step(p, None)
        tr.drain()
    tr._drain.stop()


def test_bytes_recv_equals_the_counter(two_shards):
    reg = telemetry.get_registry()
    base = reg.snapshot()
    c = tps.PSClient(two_shards, codec="int8", reply_codec="same")
    p = c.init({"w": np.zeros(300, np.float32)}, ("sgd", {}))
    c.push_pull({"w": np.ones(300, np.float32)})
    c.pull()
    c.close()
    d = telemetry.snapshot_delta(reg.snapshot(), base)
    # the negotiation's round trips precede the counters
    nego = 2 * len(json.dumps({"op": "codec_ok", "reply": "int8",
                               "tensors": []}).encode()) + 8
    assert d["counters"]["ps.bytes_recv"] == c.bytes_recv - nego
    assert d["counters"]["ps.round_trips"] == 3 * 2
    del p


def test_hierarchical_topology_is_not_ported(two_shards):
    with pytest.raises(NotImplementedError, match="hier_ps"):
        tps.AsyncTrainer(lambda p, b: p, two_shards, topology="hierarchical",
                         device="cpu")
    with pytest.raises(ValueError, match="topology"):
        tps.AsyncTrainer(lambda p, b: p, two_shards, topology="ring",
                         device="cpu")
    with pytest.raises(ValueError, match="push_every"):
        tps.AsyncTrainer(lambda p, b: p, two_shards, push_every=0,
                         device="cpu")


def test_step_without_a_gpu_raises(two_shards, monkeypatch):
    from tensorflowonspark_tpu_torch import compat

    monkeypatch.setattr(compat, "has_cuda", lambda: False)
    with pytest.raises(compat.NoCudaDevice):
        tps.AsyncTrainer(lambda p, b: p, two_shards)
