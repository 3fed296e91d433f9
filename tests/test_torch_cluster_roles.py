"""The source system's own cluster roles in the port, on its
``LocalEngine`` and the CPU, held to the JAX package's flows: the cluster
template, a ps node running ``parallel.ps.run_server`` with workers
training against it (``tests/test_ps.py``'s cluster flows, by
``PSClient`` and by ``AsyncTrainer(device="cpu")``), shards hosted by
the driver, the evaluator role (``tests/test_cluster.py``'s
``test_eval_node_role``), and the managed TensorBoard, with a stub
``tensorboard`` first on the executors' ``PATH`` and with none at all.

The user fns are module-level (pickled by reference; the spawned
processes import this module, so it imports JAX only inside tests).
Every run is bounded: reservation timeouts of 60 s, ``shutdown(timeout=
60)``.  The SPARK-mode runs use the work-stealing engine, as the
reference's do: a service node's start task pins its executor, so feed
tasks go to the workers.
"""

import json
import os
import signal
import sys
import time
import urllib.request

import numpy as np
import pytest

from tensorflowonspark_tpu_torch.cluster import cluster, manager, node
from tensorflowonspark_tpu_torch.engine import LocalEngine

BOUNDS = dict(reservation_timeout=60)
TARGET = [3.14, 1.618]

# --- user fns (module-level: pickled by reference) ----------------------


def _ps_client_fn(args, ctx):
    """``tests/test_ps.py``'s ``_ps_main_fun`` on the port: ps nodes
    serve, workers converge a quadratic by push_pull."""
    from tensorflowonspark_tpu_torch.parallel import ps

    if ctx.job_name == "ps":
        ps.run_server(ctx)
        return
    target = np.array(TARGET, np.float32)
    client = ps.PSClient(ctx.cluster_spec["ps"])
    p = client.init({"w": np.zeros(2, np.float32)},
                    ("sgd", {"learning_rate": 0.05}))
    for _ in range(150):
        g = 2.0 * (p["w"] - target)
        p = client.push_pull({"w": g.astype(np.float32)})
    final = client.pull()
    client.close()
    err = float(np.abs(final["w"] - target).max())
    assert err < 1e-2, "async PS failed to converge: {0}".format(final["w"])
    with open(os.path.join(args, "worker%d.json" % ctx.task_index),
              "w") as f:
        json.dump({"w": final["w"].tolist(), "ps": ctx.cluster_spec["ps"],
                   "jax": sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "flax"))}, f)


def _ps_trainer_fn(args, ctx):
    """The same flow through ``AsyncTrainer(device="cpu")``; the ps
    process records whether ``torch`` made a CUDA context."""
    import torch

    from tensorflowonspark_tpu_torch.parallel import ps

    if ctx.job_name == "ps":
        ps.run_server(ctx)
        return
    target = torch.tensor(TARGET)
    trainer = ps.AsyncTrainer(
        lambda p, b: torch.sum((p["w"] - target) ** 2),
        ctx.cluster_spec["ps"], optimizer=("sgd", {"learning_rate": 0.05}),
        device="cpu")
    p = trainer.init({"w": torch.zeros(2)})
    for _ in range(150):
        p = trainer.step(p, None)
    final = trainer.drain()
    trainer.stop()
    with open(os.path.join(args, "trainer%d.json" % ctx.task_index),
              "w") as f:
        json.dump({"w": final["w"].tolist()}, f)


def _eval_role_fn(args, ctx):
    # the reference's _eval_role_fn (tests/test_cluster.py)
    if ctx.job_name == "evaluator":
        ctx.mgr.set("saw_evaluator", True)
        return
    feed = ctx.get_data_feed(train_mode=True)
    seen = 0
    while not feed.should_stop():
        seen += len(feed.next_batch(8))
    ctx.mgr.set("rows_seen", seen)


def _noop_fn(args, ctx):
    pass


# --- the cluster template -----------------------------------------------


def test_cluster_template_matches_the_reference():
    from tensorflowonspark_tpu.cluster import node as jnode

    for n in range(1, 7):
        for num_ps in range(0, 3):
            for master in (None, "chief", "master"):
                for ev in (False, True):
                    assert node._cluster_template(
                        n, num_ps, master_node=master, eval_node=ev) == \
                        jnode._cluster_template(
                            n, num_ps, master_node=master, eval_node=ev)


# --- parameter-server nodes ---------------------------------------------


def test_cluster_with_ps_node(tmp_path):
    engine = LocalEngine(3)
    try:
        c = cluster.run(engine, _ps_client_fn, str(tmp_path),
                        num_executors=3, num_ps=1,
                        input_mode=cluster.InputMode.TENSORFLOW, **BOUNDS)
        roles = sorted(n["job_name"] for n in c.cluster_info)
        assert roles == ["ps", "worker", "worker"]
        ps_node = next(n for n in c.cluster_info if n["job_name"] == "ps")
        c.shutdown(timeout=60)
        # shutdown released the ps node's control loop and stopped it
        m = manager.connect(tuple(ps_node["addr"]),
                            bytes.fromhex(ps_node["authkey"]))
        assert str(m.get("state")._getvalue()) == "stopped"
    finally:
        engine.stop()
    for i in range(2):
        with open(tmp_path / ("worker%d.json" % i)) as f:
            got = json.load(f)
        np.testing.assert_allclose(got["w"], TARGET, atol=1e-2)
        assert got["jax"] == []


def test_cluster_with_ps_node_async_trainer_on_cpu(tmp_path):
    engine = LocalEngine(2)
    try:
        c = cluster.run(engine, _ps_trainer_fn, str(tmp_path),
                        num_executors=2, num_ps=1,
                        input_mode=cluster.InputMode.TENSORFLOW, **BOUNDS)
        c.shutdown(timeout=60)
    finally:
        engine.stop()
    with open(tmp_path / "trainer0.json") as f:
        np.testing.assert_allclose(json.load(f)["w"], TARGET, atol=1e-2)


def test_cluster_with_driver_ps_nodes(tmp_path):
    engine = LocalEngine(2)
    try:
        c = cluster.run(engine, _ps_client_fn, str(tmp_path),
                        num_executors=2, num_ps=1, driver_ps_nodes=True,
                        input_mode=cluster.InputMode.TENSORFLOW, **BOUNDS)
        addrs = c.cluster_meta["driver_ps_addrs"]
        assert len(addrs) == 1
        # both executors are workers: no ps role took an executor
        assert sorted(n["job_name"] for n in c.cluster_info) == [
            "worker", "worker"]
        shard = c._driver_ps[0]
        c.shutdown(timeout=60)
        assert shard._stop.is_set()  # stopped with the cluster
    finally:
        engine.stop()
    for i in range(2):
        with open(tmp_path / ("worker%d.json" % i)) as f:
            got = json.load(f)
        assert got["ps"] == addrs
        np.testing.assert_allclose(got["w"], TARGET, atol=1e-2)


@pytest.mark.parametrize("kw", [
    dict(num_executors=2, num_ps=2),
    dict(num_executors=2, num_ps=1, eval_node=True),
    dict(num_executors=2, num_ps=2, master_node="chief"),
    dict(num_executors=1, eval_node=True),
], ids=["ps_only", "ps_and_evaluator", "ps_and_chief", "evaluator_only"])
def test_size_check_matches_the_reference(kw):
    from tensorflowonspark_tpu.cluster import cluster as jcluster

    class _Fleet(object):  # checked before any process starts
        num_executors = kw["num_executors"]
        num_executors_exact = True
        default_fs = "file://"

    with pytest.raises(ValueError) as want:
        jcluster.run(_Fleet(), _noop_fn, **kw)
    with pytest.raises(ValueError) as got:
        cluster.run(_Fleet(), _noop_fn, **kw)
    assert str(got.value) == str(want.value)


# --- the evaluator ------------------------------------------------------


def test_eval_node_role():
    engine = LocalEngine(2)
    try:
        c = cluster.run(engine, _eval_role_fn, num_executors=2,
                        eval_node=True, input_mode=cluster.InputMode.SPARK,
                        **BOUNDS)
        assert sorted(n["job_name"] for n in c.cluster_info) == [
            "evaluator", "worker"]
        c.train([[1, 2, 3], [4, 5]], feed_timeout=60)
        ev = next(n for n in c.cluster_info if n["job_name"] == "evaluator")
        wk = next(n for n in c.cluster_info if n["job_name"] == "worker")
        m = manager.connect(tuple(ev["addr"]), bytes.fromhex(ev["authkey"]))
        deadline = time.time() + 30
        while time.time() < deadline:
            if m.get("saw_evaluator")._getvalue():
                break
            time.sleep(0.2)
        assert m.get("saw_evaluator")._getvalue() is True
        # a service node has only its control and error queues
        with pytest.raises(Exception):
            m.get_queue("input")
        c.shutdown(timeout=60)
        # every fed row reached the worker
        wm = manager.connect(tuple(wk["addr"]), bytes.fromhex(wk["authkey"]))
        assert wm.get("rows_seen")._getvalue() == 5
        assert str(m.get("state")._getvalue()) == "stopped"
    finally:
        engine.stop()


# --- the managed TensorBoard --------------------------------------------

_STUB = '''#!{python}
"""A stand-in tensorboard: serves HTTP 200 on --port."""
import http.server, sys
port = int([a for a in sys.argv if a.startswith("--port=")][0][7:])
open({marker!r}, "w").write(" ".join(sys.argv[1:]))


class H(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"tensorboard stub")

    def log_message(self, *a):
        pass


http.server.HTTPServer(("", port), H).serve_forever()
'''


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_tensorboard_stub_on_path(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "tensorboard"
    marker = tmp_path / "argv"
    stub.write_text(_STUB.format(python=sys.executable, marker=str(marker)))
    stub.chmod(0o755)
    env = {"PATH": "{0}{1}{2}".format(bindir, os.pathsep,
                                      os.environ.get("PATH", ""))}
    engine = LocalEngine(2, env=env)
    try:
        c = cluster.run(engine, _noop_fn, num_executors=2,
                        tensorboard=True, log_dir=str(tmp_path / "logs"),
                        input_mode=cluster.InputMode.TENSORFLOW, **BOUNDS)
        url = c.tensorboard_url()
        tb = [n for n in c.cluster_info if n.get("tb_pid")]
        # exactly one node, worker:0 when there is no chief
        assert [(n["job_name"], n["task_index"]) for n in tb] == [
            ("worker", 0)]
        assert url == "http://{0}:{1}".format(tb[0]["host"], tb[0]["tb_port"])
        deadline = time.time() + 30
        while True:
            try:
                with urllib.request.urlopen(url, timeout=5) as r:
                    assert r.status == 200
                    break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        assert marker.read_text() == "--logdir={0} --port={1} --bind_all" \
            .format(tmp_path / "logs", tb[0]["tb_port"])
        pid = tb[0]["tb_pid"]
        c.shutdown(timeout=60)
        deadline = time.time() + 10
        while _alive(pid) and time.time() < deadline:
            time.sleep(0.1)
        assert not _alive(pid)
    finally:
        engine.stop()


def test_tensorboard_absent_cluster_comes_up(tmp_path, monkeypatch):
    from tensorflowonspark_tpu import tensorboard as jtb
    from tensorflowonspark_tpu_torch import tensorboard as ttb

    # none on PATH and none importable: both packages give (None, 0)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setitem(sys.modules, "tensorboard", None)
    assert ttb.find_tensorboard() is None
    assert ttb.start_tensorboard(str(tmp_path)) == jtb.start_tensorboard(
        str(tmp_path)) == (None, 0)
    monkeypatch.undo()
    # and on the executors: a shadow package that refuses to import,
    # first on the sys.path the spawned executors inherit
    shadow = tmp_path / "shadow" / "tensorboard"
    shadow.mkdir(parents=True)
    (shadow / "__init__.py").write_text("raise ImportError('no tensorboard')")
    monkeypatch.syspath_prepend(str(tmp_path / "shadow"))
    engine = LocalEngine(1, env={"PATH": os.path.dirname(sys.executable)})
    try:
        c = cluster.run(engine, _noop_fn, num_executors=1, tensorboard=True,
                        log_dir=str(tmp_path),
                        input_mode=cluster.InputMode.TENSORFLOW, **BOUNDS)
        assert c.tensorboard_url() is None
        assert [n["tb_pid"] for n in c.cluster_info] == [0]
        c.shutdown(timeout=60)
    finally:
        engine.stop()


def test_stop_tensorboard_sends_sigterm(monkeypatch):
    # a node on this host gets SIGTERM; one elsewhere is left to its
    # executor (as the reference's _stop_tensorboard)
    from tensorflowonspark_tpu_torch.utils.net import get_ip_address

    sent = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: sent.append((pid, sig)))
    c = cluster.TPUCluster.__new__(cluster.TPUCluster)
    c.cluster_info = [{"host": get_ip_address(), "tb_pid": 11},
                      {"host": "10.255.0.9", "tb_pid": 12},
                      {"host": get_ip_address(), "tb_pid": 0}]
    c._stop_tensorboard()
    assert sent == [(11, signal.SIGTERM)]
