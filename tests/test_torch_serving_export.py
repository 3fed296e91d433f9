"""Serving from an export across the two packages, on the CPU.

- The JAX package exports a tiny model's Flax tree with its own
  ``model_ref``; ``convert_jax_export.py`` rewrites it; the port serves
  it through ``load_predictor`` -> ``predict_rows(schedule=
  "continuous")`` with greedy tokens equal to the JAX package's own
  ``load_predictor`` over the same export.
- The other way: weights trained 3 steps in the port and exported by the
  port serve the same greedy tokens under the JAX package's
  ``load_predictor`` as under the port's.
- ``resolve_ref`` maps the JAX package's module paths to the port's
  without importing the JAX package; a module the port lacks raises
  ``NotImplementedError`` naming its item; ``config_overrides``,
  ``use_cache`` and ``with_preprocess``.

Greedy tokens are compared exactly, as ``tests/test_torch_serving.py``
compares them (the port's decode and the JAX package's ``gather`` decode,
both in f32).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import convert_jax_export  # noqa: E402
from tensorflowonspark_tpu import checkpoint as jck  # noqa: E402
from tensorflowonspark_tpu import serving as jserving  # noqa: E402
from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu_torch import checkpoint as tck  # noqa: E402
from tensorflowonspark_tpu_torch import convert, optim, serving  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)
from tensorflowonspark_tpu_torch.parallel import dp  # noqa: E402

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, embed_dim=64, mlp_dim=128, max_seq_len=128,
            dtype="float32")
GEN = dict(mode="generate", kv_layout="paged", kv_page_tokens=8,
           max_new_tokens=8, chunk_size=4, pad_multiple=16,
           max_prompt_len=40)
JAX_REF = "tensorflowonspark_tpu.models.transformer:serving_builder"
METADATA = {"model_ref": JAX_REF, "model_config": dict(TINY, **GEN)}
#: deployment knobs of each package on the CPU
PORT_CPU = {"device": "cpu"}
JAX_CPU = {"paged_impl": "gather"}
PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tensorflowonspark_tpu_torch")


def _rows(n=7, seed=4):
    rng = np.random.RandomState(seed)
    return [{"prompt": rng.randint(0, 256, (int(m),)).astype(np.int32)}
            for m in rng.randint(1, 41, (n,))]


def _tokens(mod, predict, rows):
    out = list(mod.predict_rows(
        predict, [dict(r) for r in rows], {"prompt": "tokens"},
        batch_size=3, schedule="continuous"))
    assert len(out) == len(rows)
    return [np.asarray(r["generated"]).tolist() for r in out]


def _jax_tree(seed=0):
    model = jtr.Transformer(jtr.TransformerConfig(**TINY))
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def test_jax_export_serves_in_the_port(tmp_path):
    src = jck.save_for_serving(tmp_path / "jax", _jax_tree(),
                               extra_metadata=METADATA)
    dst = convert_jax_export.convert(src, str(tmp_path / "port"))
    rows = _rows()
    want = _tokens(jserving, jserving.load_predictor(
        dst, use_cache=False, config_overrides=JAX_CPU), rows)
    got = _tokens(serving, serving.load_predictor(
        dst, use_cache=False, config_overrides=PORT_CPU), rows)
    assert got == want
    # the original (OCDBT) export serves the JAX package the same tokens
    assert _tokens(jserving, jserving.load_predictor(
        src, use_cache=False, config_overrides=JAX_CPU), rows) == want


def test_port_trained_export_serves_in_both_packages(tmp_path):
    tree = _jax_tree(seed=1)
    model = convert.params_from_flax(
        tree, ttr.TransformerConfig(**dict(TINY, attention_impl="flash")),
        device="cpu", param_dtype=torch.float32)
    trainer = dp.SyncTrainer(ttr.loss_fn(model), optim.adamw(1e-2))
    state = trainer.create_state(dict(model.named_parameters()))
    tokens = np.random.default_rng(3).integers(0, 256, (3, 2, 64))
    for t in tokens:
        state, _ = trainer.step(state, {"tokens": t.astype(np.int32)})
    trained = convert.tree_from_model(model)
    step_dir = tck.publish_for_serving(tmp_path / "pub", 3, trained,
                                       extra_metadata=METADATA)
    assert tck.list_serving_steps(tmp_path / "pub") == [3]
    rows = _rows(seed=9)
    want = _tokens(jserving, jserving.load_predictor(
        step_dir, use_cache=False, config_overrides=JAX_CPU), rows)
    got = _tokens(serving, serving.load_predictor(
        step_dir, use_cache=False, config_overrides=PORT_CPU), rows)
    assert got == want
    # training moved the weights far enough to change what is served
    untrained = _tokens(serving, ttr.serving_builder(
        tree, dict(TINY, **GEN, **PORT_CPU)), rows)
    assert got != untrained


def test_bf16_export_serves_in_the_port(tmp_path):
    """bf16 leaves come back as torch tensors and load as they are."""
    tree = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                        _jax_tree())
    out = tck.save_for_serving(tmp_path / "e", tree, extra_metadata=METADATA)
    params, _ = tck.load_for_serving(out)
    assert params["embedding"].dtype == torch.bfloat16
    rows = _rows(n=3)
    want = _tokens(serving, ttr.serving_builder(
        jax.tree.map(lambda x: np.asarray(x, np.float32), tree),
        dict(TINY, **GEN, **PORT_CPU)), rows)
    assert _tokens(serving, serving.load_predictor(
        out, use_cache=False, config_overrides=PORT_CPU), rows) == want


def test_resolve_ref_maps_the_jax_package_to_the_port():
    assert serving.resolve_ref(JAX_REF) is ttr.serving_builder
    assert serving.resolve_ref(
        "tensorflowonspark_tpu_torch.models.transformer:serving_builder"
    ) is ttr.serving_builder
    assert serving.resolve_ref("os.path:join") is os.path.join
    with pytest.raises(ValueError, match="pkg.module:attr"):
        serving.resolve_ref("tensorflowonspark_tpu.models.transformer")


@pytest.mark.parametrize("ref,item", [
    # the model modules are ported; their sharding rules are not (A4)
    ("tensorflowonspark_tpu.models.mlp:logical_axes", "the rest"),
    ("tensorflowonspark_tpu.models.resnet:logical_axes", "the rest"),
    ("tensorflowonspark_tpu.fleet.router:build", "the rest"),
    ("tensorflowonspark_tpu.models.transformer:no_such_builder",
     "the rest"),
], ids=["mlp", "resnet", "fleet", "missing_attr"])
def test_resolve_ref_names_what_is_not_ported(ref, item):
    with pytest.raises(NotImplementedError, match=item):
        serving.resolve_ref(ref)


def test_resolving_a_jax_ref_imports_no_jax():
    code = (
        "import sys\n"
        "from tensorflowonspark_tpu_torch import serving\n"
        "serving.resolve_ref({0!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'tensorflowonspark_tpu'))\n"
        "assert not bad, bad\n"
    ).format(JAX_REF)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(PKG))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_config_overrides_and_the_cache(tmp_path):
    out = tck.save_for_serving(tmp_path / "e", _jax_tree(),
                               extra_metadata=METADATA)
    serving._PREDICTOR_CACHE.clear()
    a = serving.load_predictor(out, config_overrides=PORT_CPU)
    assert serving.load_predictor(out, config_overrides=PORT_CPU) is a
    assert serving.load_predictor(out, config_overrides=PORT_CPU,
                                  use_cache=False) is not a
    b = serving.load_predictor(out, config_overrides=dict(
        PORT_CPU, max_new_tokens=3))
    assert b is not a
    assert a.max_new_tokens == GEN["max_new_tokens"] and b.max_new_tokens == 3
    rows = _rows(n=3)
    assert [len(t) for t in _tokens(serving, b, rows)] == [3, 3, 3]
    serving._PREDICTOR_CACHE.clear()


def _scaled_builder(params, config):
    """A predictor that returns its batch times the export's scale, with
    the batch-shape attributes a generation predictor carries."""
    def predict(batch):
        return {"y": batch["x"] * float(params["scale"])}

    predict.column_padding = {"x": 0}
    predict.pad_multiple = 8
    return predict


def test_with_preprocess_and_the_metadata_stage(tmp_path):
    out = tck.save_for_serving(
        tmp_path / "e", {"scale": np.asarray(2.0, np.float32)},
        extra_metadata={"preprocess": {"columns": ["x"], "dtype": "float32",
                                       "scale": 0.5}})
    x = np.arange(4, dtype=np.uint8)
    predict = serving.load_predictor(out, builder=_scaled_builder,
                                     use_cache=False)
    y = predict({"x": x})["y"]
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(y), x.astype(np.float32))
    assert predict.column_padding == {"x": 0} and predict.pad_multiple == 8
    assert not hasattr(predict, "pad_cap")
    plain = serving.load_predictor(out, builder=_scaled_builder,
                                   use_cache=False, preprocess=False)
    np.testing.assert_array_equal(plain({"x": x})["y"], 2.0 * x)
    wrapped = serving.with_preprocess(plain, lambda b: {"x": b["x"] + 1})
    np.testing.assert_array_equal(wrapped({"x": x})["y"], 2.0 * (x + 1))
    with pytest.raises(ValueError, match="model_ref"):
        serving.load_predictor(out, use_cache=False)
