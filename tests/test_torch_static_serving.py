"""The port's static schedule, logits serving and quantized serving
against the JAX package's, on the CPU in f32.

- ``predict_rows(schedule="static")`` over the generation predictor:
  rows equal the reference's in input order (``generated`` and, under
  eos, ``generated_len``), with ``pad_cap`` bounding the buckets,
  ``pad_to_batch``, ``on_error="record"`` isolating a poison row (same
  padded shape), missing columns as typed records, and the
  continuous-only knobs refused as the reference refuses them.
- Logits serving (``serving_builder`` without ``mode``): ``logits``
  within 1e-5 of the reference's, ``next_token`` equal.
- The continuous schedule on the contiguous layout, and the int8 KV
  cache and int8/int4 weights in both layouts: tokens equal the
  reference's.  int4 weights on the paged layout give the port's own
  contiguous tokens and the reference's int4 contiguous tokens.
"""

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

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=32, embed_dim=128, mlp_dim=192, max_seq_len=80,
            dtype="float32")
GEN = dict(mode="generate", max_new_tokens=8, chunk_size=4, pad_multiple=16,
           max_prompt_len=40)
PAGED = dict(kv_layout="paged", kv_page_tokens=8)
MAPPING = {"prompt": "tokens"}
LOGITS_ATOL = 1e-5


@pytest.fixture(scope="module")
def tree():
    model = jtr.Transformer(jtr.TransformerConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _rows(n=7, seed=4, hi=41):
    rng = np.random.RandomState(seed)
    return [{"prompt": rng.randint(0, 256, (int(m),)).astype(np.int32)}
            for m in rng.randint(1, hi, (n,))]


def _jax(tree, **extra):
    cfg = dict(TINY, **dict(GEN, **extra))
    if cfg.get("kv_layout") == "paged":
        cfg["paged_impl"] = "gather"
    return jtr.serving_builder(tree, cfg)


def _port(tree, **extra):
    return ttr.serving_builder(tree, dict(TINY, **dict(GEN, device="cpu",
                                                       **extra)))


def _serve(mod, predict, rows, **kw):
    stats = {}
    kw.setdefault("batch_size", 3)
    out = list(mod.predict_rows(predict, [dict(r) for r in rows], MAPPING,
                                stats=stats, **kw))
    return out, stats


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert sorted(g) == sorted(r), i
        for key in r:
            if key == "error":
                assert g[key]["kind"] == r[key]["kind"], i
                assert g[key]["request_index"] == r[key]["request_index"]
                continue
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(r[key]),
                                          err_msg="{0} {1}".format(i, key))


def _tokens(rows):
    return [np.asarray(r["generated"]).tolist() for r in rows]


@pytest.mark.parametrize("extra", [
    {}, {"attention_window": 9}, {"cache_dtype": "int8"},
    {"pad_multiple": 64}, PAGED,
], ids=["causal", "window", "int8_cache", "pad_cap", "paged_export"])
def test_static_rows_match_jax(tree, extra):
    """``pad_multiple=64`` rounds every batch past ``max_seq_len -
    max_new`` (72): ``pad_cap`` keeps it at 72.  A paged export's static
    batches run the contiguous cache, as the reference's static schedule
    runs on a contiguous build."""
    rows = _rows()
    jextra = {k: v for k, v in extra.items() if k not in PAGED}
    ref, _ = _serve(jserving, _jax(tree, **jextra), rows)
    port = _port(tree, **extra)
    got, stats = _serve(serving, port, rows)
    _assert_same(got, ref)
    assert sorted(stats["latency_sec"]) == list(range(len(rows)))
    assert port.pad_cap == TINY["max_seq_len"] - GEN["max_new_tokens"]
    prefill, decode = port.last_timing
    assert prefill > 0 and decode > 0


def test_static_eos_and_generated_len_match_jax(tree):
    rows = _rows(seed=6)
    plain, _ = _serve(jserving, _jax(tree), rows)
    eos = int(np.asarray(plain[0]["generated"])[2])
    ref, _ = _serve(jserving, _jax(tree, eos_id=eos), rows)
    got, _ = _serve(serving, _port(tree, eos_id=eos), rows)
    _assert_same(got, ref)
    assert int(got[0]["generated_len"]) <= 2
    assert got[0]["generated_len"].dtype == np.int32


def test_static_without_pad_to_batch_matches_jax(tree):
    rows = _rows(5)
    ref, _ = _serve(jserving, _jax(tree), rows, pad_to_batch=False)
    got, _ = _serve(serving, _port(tree), rows, pad_to_batch=False)
    _assert_same(got, ref)


def test_record_isolates_a_poison_row_like_jax(tree):
    """A prompt longer than the cache fails its batch in ``generate``;
    under ``on_error="record"`` each row of that batch runs alone at the
    same padded shape and only the long row becomes a record.  A row
    without the prompt column is a ``missing_input`` record."""
    rows = _rows()
    rows.insert(2, {"prompt": np.arange(78, dtype=np.int32)})
    rows.insert(5, {"other": np.zeros((3,), np.int32)})
    ref, _ = _serve(jserving, _jax(tree), rows, on_error="record")
    got, stats = _serve(serving, _port(tree), rows, on_error="record")
    _assert_same(got, ref)
    assert got[2]["error"]["kind"] == "predict"
    assert got[5]["error"]["kind"] == "missing_input"
    assert sorted(stats["latency_sec"]) == list(range(len(rows)))
    with pytest.raises(ValueError, match="exceeds the cache"):
        _serve(serving, _port(tree), rows[:3])
    with pytest.raises(serving.RequestValidationError, match="request 2"):
        _serve(serving, _port(tree), rows[3:6])


@pytest.mark.parametrize("kw", [
    {"policy": "reject"}, {"queue_depth": 4}, {"watchdog_timeout": 1.0},
    {"default_deadline": 1.0}, {"checkpoint_dir": "/nonexistent"},
])
def test_continuous_only_knobs_refused_like_jax(tree, kw):
    for mod, pred in ((jserving, _jax(tree)), (serving, _port(tree))):
        with pytest.raises(ValueError, match="continuous-schedule knobs"):
            list(mod.predict_rows(pred, _rows(1), MAPPING, batch_size=2,
                                  **kw))


def test_reserved_inputs_refused_on_the_static_schedule(tree):
    """A tenant column (once refused outright) serves on the static
    schedule as on the JAX package's: a row whose tenant is not a
    non-empty string is refused with the same typed ``bad_tenant`` record
    (raised under ``on_error="raise"``), the other rows' tokens are
    equal, and each row lands in the usage ledger under its tenant."""
    from tensorflowonspark_tpu_torch import telemetry

    rows = [dict(r, t=("a", "b", "")[i % 3]) for i, r in enumerate(
        _rows(5))]
    mapping = dict(MAPPING, t="tenant")
    led = telemetry.get_ledger()
    base = led.snapshot()
    got = list(serving.predict_rows(_port(tree), [dict(r) for r in rows],
                                    mapping, batch_size=2,
                                    on_error="record"))
    tenants = telemetry.ledger.snapshot_delta(led.snapshot(),
                                              base)["tenants"]
    want = list(jserving.predict_rows(_jax(tree), [dict(r) for r in rows],
                                      mapping, batch_size=2,
                                      on_error="record"))
    _assert_same(got, want)
    assert [r["error"] for r in got if "error" in r] == [
        r["error"] for r in want if "error" in r]
    assert [(i, r["error"]["kind"]) for i, r in enumerate(got)
            if "error" in r] == [(2, "bad_tenant")]
    assert tenants["a"]["requests"] == tenants["b"]["requests"] == 2
    assert tenants["a"]["tokens_out"] == sum(
        int(r["generated_len"]) if "generated_len" in r
        else r["generated"].size for r in got[0::3])
    with pytest.raises(serving.RequestValidationError, match="request 2"):
        list(serving.predict_rows(_port(tree), [dict(r) for r in rows],
                                  mapping, batch_size=2))


def test_auto_schedule_and_stacking(tree):
    rows = _rows(4)
    auto, _ = _serve(serving, _port(tree), rows, schedule="auto")
    cont, _ = _serve(serving, _port(tree), rows, schedule="continuous")
    _assert_same(auto, cont)
    with pytest.raises(ValueError, match="ragged rows"):
        serving._stack_column([np.zeros(3), np.zeros(4)], "x")
    for args in (([np.arange(3), np.arange(9)], 0, 8, None),
                 ([np.arange(3), np.arange(9)], -1, 8, 12),
                 ([np.arange(30)], 0, 16, 20)):
        want = jserving._stack_ragged_left(*args[:3], cap=args[3])
        got = serving._stack_ragged_left(*args[:3], cap=args[3])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


@pytest.mark.parametrize("weights", [None, "int8", "int4"])
def test_logits_serving_matches_jax(tree, weights):
    """Logits serving (once refused): ``logits`` f32 within 1e-5,
    ``next_token`` equal; quantized weights dequantized once."""
    extra = {} if weights is None else {"weights": weights}
    tokens = np.random.RandomState(1).randint(0, 256, (3, 20)).astype(
        np.int32)
    want = jtr.serving_builder(tree, dict(TINY, **extra))({"tokens": tokens})
    got = ttr.serving_builder(tree, dict(TINY, device="cpu", **extra))(
        {"tokens": tokens})
    assert sorted(got) == ["logits", "next_token"]
    assert got["logits"].dtype == np.float32
    assert got["logits"].shape == (3, 20, TINY["vocab_size"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=LOGITS_ATOL)
    np.testing.assert_array_equal(got["next_token"], want["next_token"])
    # through predict_rows, uniform rows, static schedule
    rows = [{"prompt": t} for t in tokens]
    out = list(serving.predict_rows(
        ttr.serving_builder(tree, dict(TINY, device="cpu", **extra)), rows,
        MAPPING, batch_size=2))
    np.testing.assert_array_equal([o["next_token"] for o in out],
                                  want["next_token"])


QUANT = {
    "int8_cache": {"cache_dtype": "int8"},
    "int8_weights": {"weights": "int8"},
    "int4_weights": {"weights": "int4"},
    "int4_g32_int8_cache": {"quantize": "int4", "int4_group": 32,
                            "cache_dtype": "int8"},
}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("name", sorted(QUANT))
def test_continuous_quantized_matches_jax(tree, name, layout):
    extra = dict(QUANT[name])
    if layout == "paged":
        extra.update(PAGED)
    rows = _rows()
    ref, _ = _serve(jserving, _jax(tree, **extra), rows,
                    schedule="continuous")
    port = _port(tree, **extra)
    got, stats = _serve(serving, port, rows, schedule="continuous")
    _assert_same(got, ref)
    assert stats["kv_layout"] == layout
    dec = port.make_slot_decoder(3)
    weights = extra.get("weights") or extra.get("quantize")
    assert dec._quantized == (weights is not None) and dec._wq == weights
    if extra.get("cache_dtype") == "int8":
        assert str(dec.cache[0]["k"].dtype) == "torch.int8"
        assert "k_scale" in dec.cache[0]


def test_int4_paged_equals_contiguous_and_the_reference(tree):
    """int4 weights on the paged layout (the port's decode through the
    kernel's plain version) give the port's contiguous tokens and the
    reference's int4 contiguous tokens.  With the float KV cache only:
    the int8 cache quantizes post-rope keys, whose codes depend on the
    absolute position, and a paged admit places the prompt at canonical
    positions where a contiguous one left-pads it."""
    rows = _rows(6, seed=3)
    extra = {"weights": "int4"}
    ref, _ = _serve(jserving, _jax(tree, **extra), rows,
                    schedule="continuous")
    contig, _ = _serve(serving, _port(tree, **extra), rows,
                       schedule="continuous")
    paged, _ = _serve(serving, _port(tree, **extra, **PAGED), rows,
                      schedule="continuous")
    assert _tokens(paged) == _tokens(contig) == _tokens(ref)


def test_infer_output_schema_runs_the_static_schedule(tree):
    sample = {"prompt": np.arange(5, dtype=np.int32)}
    port = _port(tree, eos_id=3)
    want = jserving.infer_output_schema(_jax(tree, eos_id=3), dict(sample),
                                        MAPPING)
    assert serving.infer_output_schema(port, dict(sample), MAPPING) == want
    assert want == [("generated", "array<int>"), ("generated_len", "int")]
    assert len(port.last_timing) == 2
    assert port.make_slot_decoder.__name__ == "make_slot_decoder"
