"""The port's shared-memory feed ring and its wire codecs against the JAX
package's, on the CPU (``g++`` builds ``native/shm_ring.cc`` here).

- The reference's ring cases (``tests/test_shm_ring.py``: order,
  wrap-around, too large, timeout, pushv, zero length, producer death)
  on the port's ``ShmRing``, and order/wrap-around/pushv/zero length
  again with one package's ring pushing and the other's popping, in
  both directions: the segment layout is shared.
- The wire codecs: for every shape of the reference's
  ``test_wire_roundtrip_many_shapes`` the port's records are byte for
  byte the reference's, and each package decodes the other's.
- The ring source of ``DataFeed``: the same ring records and queue items
  into a reference node manager + ring and the port's give equal batches
  and ``wire_stats()``.
- The feeder on a ``LocalEngine`` with ``TFOS_SHM_FEED``: large rows go
  through the ring at their exact wire length, small rows take the
  queue by the size policy, and in a fresh driver process ragged rows
  go through the ring pickled under ``force``, the segment is unlinked
  when the engine stops and stderr holds no leaked-segment warning.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tensorflowonspark_tpu_torch.cluster import manager as tmanager
from tensorflowonspark_tpu_torch.cluster import marker as tmarker
from tensorflowonspark_tpu_torch.data import feed as tfeed
from tensorflowonspark_tpu_torch.data import shm_ring as tring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pkg(name):
    """``(shm_ring, marker, feed, manager)`` of a package.  The JAX
    package is imported here, not at the top: the cluster tests' spawned
    processes import this module for its fns."""
    if name == "torch":
        return tring, tmarker, tfeed, tmanager
    from tensorflowonspark_tpu.cluster import manager, marker
    from tensorflowonspark_tpu.data import feed, shm_ring

    return shm_ring, marker, feed, manager


@pytest.fixture()
def mgrs():
    started = {}
    for name in ("jax", "torch"):
        started[name], _ = pkg(name)[3].start(
            b"key-" + name.encode(), ["input", "output", "error"])
    yield started
    for m in started.values():
        m.shutdown()


def _name(tag):
    return "tfos_test_{0}_{1}".format(tag, os.getpid())


@pytest.fixture()
def ring():
    producer = tring.ShmRing(_name("t"), 1 << 20, create=True)
    consumer = tring.ShmRing(producer.name)
    yield producer, consumer
    consumer.close()
    producer.close()


#: (creating and pushing package, attaching and popping package)
PAIRS = [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]


@pytest.fixture(params=PAIRS, ids=["-".join(p) + "" for p in PAIRS])
def pair(request):
    src, dst = request.param
    producer = pkg(src)[0].ShmRing(_name(src + dst), 1 << 20, create=True)
    consumer = pkg(dst)[0].ShmRing(producer.name)
    producer.pkg, consumer.pkg = src, dst
    yield producer, consumer
    consumer.close()
    producer.close()


# --- the reference's ring cases ----------------------------------------


def test_push_pop_order(pair):
    p, c = pair
    msgs = [os.urandom(n) for n in (1, 100, 5000, 3)]
    for m in msgs:
        p.push(m, timeout=5)
    assert [c.pop(timeout=1) for _ in msgs] == msgs
    assert c.pop(timeout=0.01) is None


def test_wraparound_survives_many_records(pair):
    p, c = pair
    rng = np.random.RandomState(0)
    sent, got = [], []

    def consume():
        for _ in range(300):
            m = c.pop(timeout=5)
            assert m is not None
            got.append(m)

    t = threading.Thread(target=consume)
    t.start()
    for _ in range(300):  # 300 x ~4 KB over a 1 MB ring: many wraps
        m = rng.bytes(int(rng.randint(1, 8192)))
        sent.append(m)
        p.push(m, timeout=5)
    t.join(timeout=30)
    assert not t.is_alive()
    assert got == sent


def test_zero_length_record(pair):
    p, c = pair
    p.push(b"", timeout=2)
    p.push(b"after", timeout=2)
    assert c.pop(timeout=1) == b""
    assert c.pop(timeout=1) == b"after"


def test_pushv_pop_roundtrip_across_packages(pair):
    p, c = pair
    rows = [(np.full((4, 4), i, np.int32), float(i)) for i in range(5)]
    hdr, parts, total = pkg(p.pkg)[1].encode_rows_parts(rows)
    p.pushv([hdr] + parts, timeout=5)
    rec = c.pop(timeout=2)
    assert len(rec) == total
    out = pkg(c.pkg)[1].decode_columnar_record(rec)
    np.testing.assert_array_equal(out.columns[0],
                                  np.stack([r[0] for r in rows]))
    np.testing.assert_array_equal(out.columns[1], [r[1] for r in rows])


def test_record_too_large_rejected(ring):
    p, _ = ring
    with pytest.raises(ValueError, match="exceeds ring capacity"):
        p.push(b"x" * (2 << 20), timeout=1)


def test_push_times_out_when_full(ring):
    p, _ = ring
    with pytest.raises(TimeoutError):
        for _ in range(10):  # fills the 1 MB ring, then blocks
            p.push(b"y" * 200_000, timeout=0.3)


def test_pop_into_a_small_probe_buffer(ring):
    p, c = ring
    big = os.urandom(600_000)
    c._out = __import__("ctypes").create_string_buffer(16)
    p.push(big, timeout=5)
    assert c.pop(timeout=1) == big


def test_format_tag_and_producer_slot_read_across_packages(pair):
    p, c = pair
    jring = pkg("jax")[0]
    assert c.format_tag() == tring.FORMAT_LEGACY == jring.FORMAT_LEGACY
    p.set_format(tring.FORMAT_COLUMNAR_V1)
    assert c.format_tag() == jring.FORMAT_COLUMNAR_V1
    assert tring.KNOWN_FORMATS == jring.KNOWN_FORMATS
    assert c.producer_pid() == 0  # zero-filled header: none announced
    p.announce_producer()
    assert c.producer_pid() == os.getpid()
    p.announce_producer(pid=424242)  # a new producer overwrites
    assert c.producer_pid() == 424242


def test_pop_without_announced_producer_times_out_quietly(ring):
    _, c = ring
    assert c.pop(timeout=0.3) is None


def _producer_child(name, n_records):
    """Attach, announce, push, then park until killed."""
    r = tring.ShmRing(name)
    r.announce_producer()
    for i in range(n_records):
        r.push(b"rec-%d" % i)
    while True:
        time.sleep(60)


def test_pop_raises_when_child_producer_dies(ring):
    import multiprocessing

    p, c = ring
    child = multiprocessing.get_context("fork").Process(
        target=_producer_child, args=(p.name, 3), daemon=True)
    child.start()
    try:
        got = [c.pop(timeout=10.0) for _ in range(3)]
        assert [bytes(g) for g in got] == [b"rec-0", b"rec-1", b"rec-2"]
        assert c.producer_pid() == child.pid
        os.kill(child.pid, signal.SIGKILL)
        child.join(timeout=10.0)
        t0 = time.monotonic()
        with pytest.raises(tring.ProducerDiedError,
                           match=r"producer pid %d died" % child.pid):
            c.pop(timeout=60.0)
        assert time.monotonic() - t0 < 10.0
    finally:
        if child.is_alive():
            child.kill()
        child.join(timeout=5.0)


def test_create_reserves_the_segment():
    r = tring.ShmRing(_name("reserve"), 1 << 20, create=True)
    try:
        path = os.path.join("/dev/shm", r.name)
        assert os.stat(path).st_blocks * 512 >= 1 << 20
    finally:
        r.close()
    assert not os.path.exists(os.path.join("/dev/shm", r.name))


# --- the wire codecs ----------------------------------------------------


def _wire(hdr, parts):
    return hdr + b"".join(np.ascontiguousarray(p).tobytes() for p in parts)


def _shape_cases():
    rng = np.random.RandomState(0)
    for dt in (np.uint8, np.uint16, np.int32, np.int64, np.float32,
               np.float64):
        for shape in ((), (3,), (2, 5), (4, 1, 3)):
            for kind in ("tuple", "dict", "list"):
                vals = [np.asarray(rng.rand(*shape) * 100).astype(dt)
                        for _ in range(4)]
                if kind == "tuple":
                    rows = [(v, i) for i, v in enumerate(vals)]
                elif kind == "list":
                    rows = [[v, i] for i, v in enumerate(vals)]
                else:
                    rows = [{"v": v, "i": i} for i, v in enumerate(vals)]
                yield "{0}-{1}-{2}".format(np.dtype(dt).name,
                                           "x".join(map(str, shape)) or
                                           "scalar", kind), rows


SHAPE_CASES = dict(_shape_cases())


def _records(marker, rows):
    """The wire records ``marker`` makes of ``rows``: stacked columns,
    then per-row parts."""
    out = [_wire(*marker.encode_columnar_parts(marker.pack_columnar(rows)))]
    enc = marker.encode_rows_parts(rows)
    if enc is not None:
        out.append(_wire(enc[0], enc[1]))
    return out


def _columns(block):
    cols = block.columns
    return list(cols.items()) if isinstance(cols, dict) else list(
        enumerate(cols))


@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_wire_bytes_equal_the_reference_and_decode_across(case):
    jmarker = pkg("jax")[1]
    rows = SHAPE_CASES[case]
    mine, ref = _records(tmarker, rows), _records(jmarker, rows)
    assert len(mine) == 2 and mine == ref
    want = jmarker.pack_columnar(rows)
    for rec in mine:
        for decode in (tmarker.decode_columnar_record,
                       jmarker.decode_columnar_record):
            out = decode(bytearray(rec))
            assert out.count == 4 and out._list_rows == want._list_rows
            for (kw, cw), (ko, co) in zip(_columns(want), _columns(out)):
                assert kw == ko
                assert cw.dtype == co.dtype
                np.testing.assert_array_equal(cw, co)


def test_encode_rows_parts_total_is_the_record_length():
    rows = [(np.random.RandomState(i).randint(0, 255, (8, 8, 3)).astype(
        np.uint8), i) for i in range(6)]
    hdr, parts, total = tmarker.encode_rows_parts(rows)
    assert (hdr, total) == pkg("jax")[1].encode_rows_parts(rows)[::2]
    assert total == len(_wire(hdr, parts))
    assert len(hdr) % 64 == 0  # column views start 64-byte aligned


def test_decode_rejects_truncated_or_corrupt_records():
    import struct

    rows = [(np.arange(64, dtype=np.float32) + i, i) for i in range(4)]
    hdr, parts, _ = tmarker.encode_rows_parts(rows)
    rec = _wire(hdr, parts)
    assert tmarker.decode_columnar_record(rec) is not None
    for cut in (10, 13, len(hdr) - 1, len(hdr) + 5, len(rec) - 1):
        assert tmarker.decode_columnar_record(rec[:cut]) is None, cut
    lying = tmarker.COLUMNAR_MAGIC + struct.pack("<I", 1 << 30) + b"x" * 32
    assert tmarker.decode_columnar_record(lying) is None
    garbage = (tmarker.COLUMNAR_MAGIC + struct.pack("<I", 8) + b"notjson!"
               + b"y" * 8)
    assert tmarker.decode_columnar_record(garbage) is None
    for meta in ({"dtypes": [], "shapes": [], "kind": "dict", "count": 0},
                 {"dtypes": ["<f4"], "shapes": [[1]], "kind": "dict",
                  "count": 1, "keys": []},
                 {"dtypes": [], "shapes": [], "kind": "mystery",
                  "count": 0}):
        hdr_j = json.dumps(meta).encode()
        bad = (tmarker.COLUMNAR_MAGIC + struct.pack("<I", len(hdr_j))
               + hdr_j + b"\x00" * 64)
        assert tmarker.decode_columnar_record(bad) is None, meta
    assert tmarker.decode_columnar_record(
        pickle.dumps(["x"], protocol=5)) is None


def test_encoders_refuse_what_the_reference_refuses():
    import collections

    jmarker = pkg("jax")[1]
    NT = collections.namedtuple("NT", "x y")
    cases = [[NT(1, 2)], [(np.zeros(3),), (np.zeros(4),)],
             [(np.zeros(3, np.float32),), (np.zeros(3, np.float64),)],
             [1, 2, 3], [{"a": np.zeros((4, 4))}, {"b": np.zeros((4, 4))}],
             [{b"x": np.zeros(3)} for _ in range(2)]]
    for rows in cases:
        assert tmarker.encode_rows_parts(rows) is None
        assert jmarker.encode_rows_parts(rows) is None
    blk = tmarker.pack_columnar([{b"x": 1.0}, {b"x": 2.0}])
    assert blk is not None and tmarker.encode_columnar_parts(blk) is None


# --- the ring source of DataFeed ----------------------------------------


def _ring_records(name, kind):
    marker = pkg(name)[1]
    if kind == "columnar":
        rows = [{"tokens": np.arange(16, dtype=np.uint16) + i,
                 "label": np.int32(i)} for i in range(10)]
        return [_wire(*marker.encode_columnar_parts(marker.pack_columnar(
            rows[:6]))), _wire(*marker.encode_columnar_parts(
                marker.pack_columnar(rows[6:])))]
    if kind == "rows_parts":
        rows = [(np.full((8, 8), i, np.float32), i) for i in range(6)]
        hdr, parts, _ = marker.encode_rows_parts(rows)
        return [_wire(hdr, parts)]
    assert kind == "pickled"
    return [pickle.dumps(marker.Block([[1], [2, 3], "ragged"]), protocol=5),
            b"", pickle.dumps([[4], [5]], protocol=5)]


RING_FEED_CASES = {
    "columnar": [("next_arrays", 4)] * 3 + [("should_stop",),
                                           ("next_arrays", 4)],
    "rows_parts": [("next_arrays", 4), ("next_arrays", 4)],
    "pickled": [("next_batch", 2), ("next_batch", 10), ("should_stop",)],
}


def _drive_ring(name, mgr, kind, calls):
    """Ring records of ``kind`` then ``None`` on the queue into a node of
    package ``name``; the outputs of ``calls``, the rows and records
    accounted, and whether the wire bytes were the records' lengths."""
    shm_ring, _, feed_mod, _ = pkg(name)
    ring = shm_ring.ShmRing(_name("feed" + name), 1 << 20, create=True)
    try:
        ring.set_format(shm_ring.FORMAT_COLUMNAR_V1)
        mgr.set("shm_ring", {"name": ring.name, "capacity": 1 << 20})
        records = _ring_records(name, kind)
        for rec in records:
            ring.push(rec, timeout=5)
        mgr.get_queue("input").put(None)  # end of feed, after the ring
        feed = feed_mod.DataFeed(mgr)
        out = [getattr(feed, c[0])(*c[1:]) for c in calls]
        stats = feed.wire_stats()
        out.append((stats["rows"], stats["records"],
                    stats["wire_bytes"] == sum(len(r) for r in records),
                    feed._ring is not None))
        feed._ring.close(unlink=False)
        return out
    finally:
        ring.close()


@pytest.mark.parametrize("kind", sorted(RING_FEED_CASES))
def test_ring_feed_matches_jax(mgrs, kind):
    from test_torch_feed import assert_same

    calls = RING_FEED_CASES[kind]
    want = _drive_ring("jax", mgrs["jax"], kind, calls)
    got = _drive_ring("torch", mgrs["torch"], kind, calls)
    assert want[-1][2:] == (True, True)
    assert_same(got, want)


def test_unknown_ring_format_stays_on_the_queue(mgrs):
    mgr = mgrs["torch"]
    ring = tring.ShmRing(_name("fmt"), 1 << 16, create=True)
    try:
        ring.set_format(7)
        ring.push(b"never read", timeout=1)
        mgr.set("shm_ring", {"name": ring.name, "capacity": 1 << 16})
        q = mgr.get_queue("input")
        q.put([1])
        q.put(None)
        feed = tfeed.DataFeed(mgr)
        assert feed.next_batch(4) == [[1]]
        assert feed._ring is None and ring.size() > 0
    finally:
        ring.close()


def test_terminate_drains_the_ring(mgrs):
    mgr = mgrs["torch"]
    ring = tring.ShmRing(_name("term"), 1 << 16, create=True)
    try:
        ring.set_format(tring.FORMAT_COLUMNAR_V1)
        mgr.set("shm_ring", {"name": ring.name, "capacity": 1 << 16})
        for i in range(5):
            ring.push(pickle.dumps([[i]]), timeout=1)
        feed = tfeed.DataFeed(mgr)
        feed.terminate()
        assert ring.size() == 0 and feed._ring is None
        assert mgr.get("state")._getvalue() == "terminating"
    finally:
        ring.close()


# --- the feeder on a LocalEngine -----------------------------------------


def _ring_consume_fn(args, ctx):
    """Consume the feed columnar; write rows, values, the source and the
    wire accounting."""
    feed = ctx.get_data_feed()
    total, sums = 0, []
    while True:
        cols, n = feed.next_arrays(16)
        if n == 0:
            break
        total += n
        sums.append(int(np.asarray(cols["x"]).astype(np.int64).sum()))
    with open(args, "w") as f:
        json.dump({"rows": total, "sum": sum(sums),
                   "wire": feed.wire_stats(),
                   "ring": feed._ring is not None}, f)


@pytest.fixture(scope="module")
def ring_engine():
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    eng = LocalEngine(1, env={"TFOS_SHM_FEED": "1"})
    yield eng
    eng.stop()


@pytest.mark.parametrize("width,via", [(2048, "ring"), (64, "queue")])
def test_feeder_ring_policy(ring_engine, tmp_path, width, via):
    """``TFOS_SHM_FEED=1``: 4096-byte rows meet the default
    ``TFOS_SHM_RING_MIN_ROW_BYTES`` and go through the ring, one wire
    record per block at its exact encoded length; 128-byte rows take the
    queue at payload bytes."""
    from tensorflowonspark_tpu_torch.cluster import cluster

    rows = [{"x": np.full(width, i, np.uint16)} for i in range(40)]
    out = str(tmp_path / "out.json")
    c = cluster.run(ring_engine, _ring_consume_fn, out, num_executors=1,
                    reservation_timeout=60)
    c.train([rows[:20], rows[20:]], feed_timeout=60)
    c.shutdown(timeout=60)
    with open(out) as f:
        got = json.load(f)
    assert got["rows"] == 40 and got["ring"] is True
    assert got["sum"] == width * sum(range(40))
    blocks = [tmarker.pack_columnar(rows[:20]),
              tmarker.pack_columnar(rows[20:])]
    if via == "ring":
        want = sum(len(h) + sum(b.nbytes for b in bs) for h, bs in (
            tmarker.encode_columnar_parts(b) for b in blocks))
    else:
        want = 40 * width * 2
    assert got["wire"]["wire_bytes"] == want
    assert got["wire"]["records"] == 2


DRIVER = r"""
import json, os, sys
sys.path.insert(0, {tests!r})
import numpy as np
from tensorflowonspark_tpu_torch.cluster import cluster
from tensorflowonspark_tpu_torch.engine import LocalEngine
import test_torch_shm_ring as t

eng = LocalEngine(1, env={{"TFOS_SHM_FEED": "force"}})
try:
    c = cluster.run(eng, t._count_fn, {out!r}, num_executors=1,
                    reservation_timeout=60)
    ring = "tfos_{{0}}_0".format(c.cluster_id[-8:])
    existed = os.path.exists(os.path.join("/dev/shm", ring))
    ragged = [(i, list(range(i % 3 + 1))) for i in range(50)]
    big = [{{"x": np.full(20000, i, np.float32)}} for i in range(8)]
    c.train([ragged, big], feed_timeout=60)
    c.shutdown(timeout=60)
finally:
    eng.stop()
print(json.dumps([existed, os.path.exists(os.path.join("/dev/shm", ring))]))
"""


def _count_fn(args, ctx):
    feed = ctx.get_data_feed()
    total = 0
    while not feed.should_stop():
        total += len(feed.next_batch(16))
    with open(args, "w") as f:
        json.dump({"rows": total, "wire": feed.wire_stats()}, f)


def test_forced_ring_in_a_fresh_driver_leaves_no_segment(tmp_path):
    """Ragged rows (the pickled fallback) and 80 KB rows (per-row parts)
    through a forced ring; after ``engine.stop()`` the executor has
    unlinked its segment, and the driver's stderr (where the resource
    tracker reports leaked segments at exit) holds no warning."""
    out = str(tmp_path / "out.json")
    code = DRIVER.format(tests=os.path.dirname(os.path.abspath(__file__)),
                         out=out)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    # the ring existed while the cluster ran, and is gone after stop()
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [True, False]
    assert "leaked" not in proc.stderr and "Traceback" not in proc.stderr, \
        proc.stderr
    with open(out) as f:
        got = json.load(f)
    assert got["rows"] == 58
    # 8 rows of 80,000 B in one per-row-parts record + the pickled block
    assert got["wire"]["records"] == 2
    assert got["wire"]["wire_bytes"] > 8 * 80000
