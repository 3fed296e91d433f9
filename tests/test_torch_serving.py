"""The port's ``serving_builder`` + ``predict_rows(schedule="continuous")``
against the JAX package's pair, on the CPU in f32: identical generated
tokens (and ``generated_len`` under eos) in input order, typed error
records, every unported knob raising, the knobs this package has ported
since building, and the package's import hygiene.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu import serving as jserving  # noqa: E402
from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu_torch import serving  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)
from tensorflowonspark_tpu_torch.planner import knobs  # noqa: E402

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, embed_dim=64, mlp_dim=128, max_seq_len=128,
            dtype="float32")
GEN = dict(mode="generate", kv_layout="paged", kv_page_tokens=8,
           max_new_tokens=8, chunk_size=4, pad_multiple=16,
           max_prompt_len=40)
PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tensorflowonspark_tpu_torch")


@pytest.fixture(scope="module")
def tree():
    model = jtr.Transformer(jtr.TransformerConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _rows(n=7, seed=4):
    rng = np.random.RandomState(seed)
    return [{"prompt": rng.randint(0, 256, (int(m),)).astype(np.int32)}
            for m in rng.randint(1, 41, (n,))]


def _serve(mod, predict, rows, **kw):
    stats = {}
    out = list(mod.predict_rows(
        predict, [dict(r) for r in rows], {"prompt": "tokens"},
        batch_size=3, schedule="continuous", stats=stats, **kw))
    return out, stats


def _jax(tree, **extra):
    return jtr.serving_builder(
        tree, dict(TINY, **GEN, paged_impl="gather", **extra))


def _port(tree, impl="kernel", **extra):
    return ttr.serving_builder(
        tree, dict(TINY, **GEN, paged_impl=impl, device="cpu", **extra))


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert sorted(g) == sorted(r), i
        for key in r:
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(r[key]), err_msg=key)


@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_continuous_matches_jax(tree, impl):
    rows = _rows()
    ref, _ = _serve(jserving, _jax(tree), rows)
    got, stats = _serve(serving, _port(tree, impl), rows)
    _assert_same(got, ref)
    assert stats["admitted"] == 7 and stats["completed"] == 7
    assert stats["tokens_out"] == 7 * GEN["max_new_tokens"]
    assert sorted(stats["latency_sec"]) == list(range(7))
    assert sorted(stats["ttft_sec"]) == list(range(7))
    assert stats["chunks"] > 0 and stats["kv_layout"] == "paged"
    assert stats["pool_pages_used"] == 0  # every slot released its pages


def test_eos_stops_rows_like_jax(tree):
    rows = _rows(seed=6)
    plain, _ = _serve(jserving, _jax(tree), rows)
    # a token the first request emits mid-run: its row must stop there
    eos = int(np.asarray(plain[0]["generated"])[2])
    ref, _ = _serve(jserving, _jax(tree, eos_id=eos), rows)
    got, stats = _serve(serving, _port(tree, eos_id=eos), rows)
    _assert_same(got, ref)
    assert int(got[0]["generated_len"]) <= 2
    assert stats["tokens_out"] == sum(int(r["generated_len"]) for r in got)


def test_over_long_prompt_becomes_a_typed_record(tree):
    rows = _rows()
    rows.insert(3, {"prompt": np.zeros((GEN["max_prompt_len"] + 30,),
                                       np.int32)})
    ref, _ = _serve(jserving, _jax(tree), rows, on_error="record")
    got, stats = _serve(serving, _port(tree), rows, on_error="record")
    assert got[3]["error"]["kind"] == ref[3]["error"]["kind"] == "too_long"
    assert got[3]["error"]["request_index"] == 3
    assert stats["errors"] == 1 and stats["completed"] == 7
    _assert_same(got[:3] + got[4:], ref[:3] + ref[4:])
    with pytest.raises(serving.RequestValidationError, match="request 3"):
        _serve(serving, _port(tree), rows)


def test_output_mapping_and_missing_column(tree):
    rows = _rows(3)
    got, _ = _serve(serving, _port(tree), rows,
                    output_mapping={"generated": "text"})
    assert all(sorted(r) == ["text"] for r in got)
    rows.append({"other": np.zeros((3,), np.int32)})
    got, _ = _serve(serving, _port(tree), rows, on_error="record")
    assert got[3]["error"]["kind"] == "missing_input"


@pytest.mark.parametrize("knob,value", [
    ("ngram", 3),
    ("speculative", True), ("draft_config", {"num_layers": 1}),
    ("tp", 2), ("mesh_shape", {"model": 2}), ("disaggregate", True),
    ("auto", True), ("profile_dir", "/nonexistent"),
])
def test_unported_builder_knobs_raise(tree, knob, value):
    with pytest.raises(NotImplementedError):
        ttr.serving_builder(tree, dict(TINY, **dict(GEN, device="cpu",
                                                    **{knob: value})))


@pytest.mark.parametrize("knob,value", [
    ("weights", "int8"), ("quantize", "int4"),
    ("kv_layout", "contiguous"), ("mode", "logits"),
    ("prefix_cache", True), ("prefix_mem_mb", 1.0),
])
def test_ported_builder_knobs_serve_like_jax(tree, knob, value):
    """Once refused: int8/int4 weights, the contiguous layout, logits
    serving (``mode`` other than ``"generate"``) and the prefix cache
    now build, and serve what the JAX package serves."""
    cfg = dict(TINY, **dict(GEN, **{knob: value}))
    if knob.startswith("prefix"):
        # the radix block is the page (GEN's kv_page_tokens)
        cfg.update(prefix_cache=True, prefix_block=GEN["kv_page_tokens"])
    jax_cfg = dict(cfg, paged_impl="gather")
    port = ttr.serving_builder(tree, dict(cfg, device="cpu"))
    ref = jtr.serving_builder(tree, jax_cfg)
    if knob == "mode":
        tokens = np.random.RandomState(1).randint(0, 256, (2, 12))
        got, want = port({"tokens": tokens}), ref({"tokens": tokens})
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got["next_token"],
                                      want["next_token"])
        return
    got, _ = _serve(serving, port, _rows())
    want, _ = _serve(jserving, ref, _rows())
    _assert_same(got, want)


def test_unknown_key_raises_like_the_registry(tree):
    with pytest.raises(knobs.UnknownKnobError, match="kv_page_tokens"):
        ttr.serving_builder(tree, dict(TINY, **GEN, device="cpu",
                                       kv_page_token=8))


@pytest.mark.parametrize("kw", [
    {"replicas": 2}, {"replica_policy": "prefix_affinity"},
    {"fleet_queue_depth": 4},
    {"input_mapping": {"prompt": "tokens", "t": "tenant"}},
    {"input_mapping": {"prompt": "tokens", "t": "trace_id"}},
    {"disaggregate": True},
])
def test_unported_predict_rows_knobs_raise(tree, kw):
    """Fleet replicas, the telemetry plane's reserved inputs and a
    disaggregated predictor (the robustness knobs are ported: see
    test_torch_serving_robustness.py)."""
    kw = dict({"schedule": "continuous"}, **kw)
    mapping = kw.pop("input_mapping", {"prompt": "tokens"})
    predict = _port(tree)
    if kw.pop("disaggregate", False):
        predict.disaggregate = True
    rows = [dict(r, t="x") for r in _rows(1)]
    with pytest.raises(NotImplementedError):
        list(serving.predict_rows(predict, rows, mapping, batch_size=2,
                                  **kw))


def test_static_schedule_serves_like_jax(tree):
    """``schedule="static"`` (once refused) runs: the paged export's
    static batches go through the contiguous cache, as the JAX package's
    static schedule does on a contiguous build of the same weights."""
    rows = _rows()
    got = list(serving.predict_rows(_port(tree), [dict(r) for r in rows],
                                    {"prompt": "tokens"}, batch_size=3))
    want = list(jserving.predict_rows(
        jtr.serving_builder(tree, dict(TINY, **dict(
            GEN, kv_layout="contiguous"))),
        [dict(r) for r in rows], {"prompt": "tokens"}, batch_size=3))
    _assert_same(got, want)


def test_static_predict_call_generates_like_jax(tree):
    """Calling the generation predictor (once refused) is the static
    schedule's batch: left-padded rows with their pad counts."""
    tokens = np.random.RandomState(2).randint(0, 256, (2, 16))
    pads = np.asarray([0, 9], np.int32)
    tokens[1, :9] = 0
    batch = {"tokens": tokens.astype(np.int32), "tokens_pad": pads}
    got = _port(tree)(dict(batch))
    want = jtr.serving_builder(tree, dict(TINY, **dict(
        GEN, kv_layout="contiguous")))(dict(batch))
    assert sorted(got) == sorted(want) == ["generated"]
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["generated"].dtype == np.int32


def test_predictor_surface(tree):
    p = _port(tree)
    assert p.max_new_tokens == GEN["max_new_tokens"]
    assert p.pad_multiple == GEN["pad_multiple"]
    assert p.column_padding == {"tokens": 0}
    assert p.pad_cap == TINY["max_seq_len"] - GEN["max_new_tokens"]
    assert p.eos_id is None
    dec = p.make_slot_decoder(3)
    assert dec.cache_len == 48 + GEN["max_new_tokens"]
    assert p.make_slot_decoder(3) is dec  # memoized per (slots, chunk)


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import tensorflowonspark_tpu_torch\n"
        "from tensorflowonspark_tpu_torch import checkpoint, compat, "
        "convert, hot_swap, optim, prefix_cache, quantize, serving, "
        "serving_engine\n"
        "from tensorflowonspark_tpu_torch.testing import chaos\n"
        "from tensorflowonspark_tpu_torch.models import base, layers, "
        "linear, mlp, moe, resnet, transformer, unet\n"
        "from tensorflowonspark_tpu_torch.ops import _build, attention, "
        "flash_attention, gmm, moe, paged_attention, ring_attention, "
        "ulysses\n"
        "from tensorflowonspark_tpu_torch.parallel import cp, dp, mesh\n"
        "from tensorflowonspark_tpu_torch.planner import knobs\n"
        "from tensorflowonspark_tpu_torch import cluster, engine\n"
        "from tensorflowonspark_tpu_torch.cluster import gpu_info, manager, "
        "node, parallel_run, reservation, supervisor\n"
        "from tensorflowonspark_tpu_torch.data import _native, columnar, "
        "dataset, example, feed, interchange, preprocess, shm_ring, "
        "spark_io, tfrecord\n"
        "from tensorflowonspark_tpu_torch import pipeline\n"
        "from tensorflowonspark_tpu_torch.utils import fs\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'tensorflowonspark_tpu'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(PKG)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cluster_plane_imports_no_torch():
    """The driver and executor side of the cluster plane and the data
    plane's host modules (native loader, shm ring, wire codecs, columnar
    decode, Example and TFRecord codecs, the preprocess factory) never
    import ``torch``: the executor forks its queue manager, and a CUDA
    context does not survive a fork (only the spawned compute process
    may touch the GPU)."""
    code = (
        "import sys\n"
        "from tensorflowonspark_tpu_torch import engine\n"
        "from tensorflowonspark_tpu_torch.cluster import cluster, gpu_info, "
        "manager, marker, node, parallel_run, reservation, supervisor\n"
        "from tensorflowonspark_tpu_torch.data import _native, columnar, "
        "example, feed, preprocess, shm_ring, tfrecord\n"
        "from tensorflowonspark_tpu_torch.utils import tree\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'tensorflowonspark_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(PKG)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_spark_side_imports_no_jax_pyspark_or_fsspec():
    """The Spark side and the pipeline (``pipeline``, ``engine``, the
    interchange, ``spark_io``, ``dataset``, ``utils/fs``) load no JAX,
    ``pyspark`` or ``fsspec`` when imported, nor ``torch``: ``pyspark``
    and ``fsspec`` are imported only when a DataFrame or a remote path
    shows up."""
    code = (
        "import sys\n"
        "from tensorflowonspark_tpu_torch import engine, pipeline\n"
        "from tensorflowonspark_tpu_torch.data import dataset, interchange, "
        "spark_io\n"
        "from tensorflowonspark_tpu_torch.utils import fs\n"
        "assert engine.SparkEngine and pipeline.TFEstimator\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tensorflowonspark_tpu', "
        "'pyspark', 'fsspec', 'torch'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(PKG)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_file_names_the_jax_package():
    pattern = re.compile(
        r"import jax|from jax|import flax|from flax|"
        r"tensorflowonspark_tpu(?!_torch)"
    )
    hits = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, name)
                with open(path) as f:
                    for n, line in enumerate(f, 1):
                        if pattern.search(line):
                            hits.append("{0}:{1}".format(path, n))
    assert not hits, hits
