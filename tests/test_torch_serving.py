"""The port's ``serving_builder`` + ``predict_rows(schedule="continuous")``
against the JAX package's pair, on the CPU in f32: identical generated
tokens (and ``generated_len`` under eos) in input order, typed error
records, every unported knob raising, and the package's import hygiene.
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
    ("weights", "int8"), ("quantize", "int4"), ("prefix_cache", True),
    ("speculative", True), ("draft_config", {"num_layers": 1}),
    ("tp", 2), ("mesh_shape", {"model": 2}), ("disaggregate", True),
    ("auto", True), ("profile_dir", "/nonexistent"),
    ("kv_layout", "contiguous"), ("mode", "logits"),
])
def test_unported_builder_knobs_raise(tree, knob, value):
    with pytest.raises(NotImplementedError):
        ttr.serving_builder(tree, dict(TINY, **dict(GEN, device="cpu",
                                                    **{knob: value})))


def test_unknown_key_raises_like_the_registry(tree):
    with pytest.raises(knobs.UnknownKnobError, match="kv_page_tokens"):
        ttr.serving_builder(tree, dict(TINY, **GEN, device="cpu",
                                       kv_page_token=8))


@pytest.mark.parametrize("kw", [
    {"schedule": "static"}, {"replicas": 2}, {"policy": "reject"},
    {"queue_depth": 4}, {"watchdog_timeout": 1.0},
    {"default_deadline": 1.0}, {"checkpoint_dir": "/nonexistent"},
])
def test_unported_predict_rows_knobs_raise(tree, kw):
    kw = dict({"schedule": "continuous"}, **kw)
    with pytest.raises(NotImplementedError):
        list(serving.predict_rows(_port(tree), _rows(1),
                                  {"prompt": "tokens"}, batch_size=2, **kw))


def test_static_predict_call_is_not_ported(tree):
    with pytest.raises(NotImplementedError, match="static generate"):
        _port(tree)({"tokens": np.zeros((1, 4), np.int32)})


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
        "from tensorflowonspark_tpu_torch import compat, convert, optim, "
        "prefix_cache, serving, serving_engine\n"
        "from tensorflowonspark_tpu_torch.models import moe, transformer\n"
        "from tensorflowonspark_tpu_torch.ops import _build, attention, "
        "flash_attention, gmm, moe, paged_attention\n"
        "from tensorflowonspark_tpu_torch.parallel import dp\n"
        "from tensorflowonspark_tpu_torch.planner import knobs\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tensorflowonspark_tpu'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
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
