"""The port's gradient codecs (``tensorflowonspark_tpu_torch/compress.py``)
held to the JAX package's ``compress.py`` to the bit: the encoded parts
and meta of every codec over seeded float32 and bfloat16 arrays of
several shapes (a non-contiguous view, the zero tensor, top-k at and
below ``min_size`` included), the decodes, ``get_codec``'s specs and
rejections, and ``ErrorFeedback``'s residuals over 20 pushes.

The port carries bfloat16 as its ``uint16`` bits (``compress.BFLOAT16``,
named ``"bfloat16"`` like the reference's ``ml_dtypes`` dtype); the
reference's side of each case is the ``ml_dtypes`` array with the same
bits.  Tolerance: none, every comparison is of bytes.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import compress as jc
from tensorflowonspark_tpu_torch import compress as tc

SHAPES = [(7,), (33, 17), (4, 5, 6), (2000,), (64, 48), ()]
CODECS = [
    ("int8", {}),
    ("topk", {"ratio": 0.05, "min_size": 16}),
    ("topk", {"ratio": 0.3, "min_size": 1024}),  # dense below min_size
    ("topk", {"ratio": 1.0, "min_size": 1}),
    ("none", {}),
]
IDS = ["int8", "topk5", "topk_dense", "topk_all", "none"]


def _arrays(seed, shape, bf16):
    """The same values on both sides: ``(reference array, port array)``."""
    rng = np.random.RandomState(seed)
    f = np.asarray((np.asarray(rng.randn(*shape))
                    * rng.uniform(0.01, 10.0)).astype(np.float32))
    if not bf16:
        return f, f.copy()
    j = np.asarray(f.astype(ml_dtypes.bfloat16))
    return j, np.asarray(j.view(np.uint16)).view(tc.BFLOAT16)


def _bits(a):
    """An array's bytes and canonical dtype name, for equality."""
    a = np.ascontiguousarray(a)
    name = "bfloat16" if (a.dtype == ml_dtypes.bfloat16
                          or tc.is_bf16(a.dtype)) else a.dtype.str
    return name, a.shape, a.tobytes()


def _same_encoding(got, want):
    (gp, gm), (wp, wm) = got, want
    assert json.dumps(gm, sort_keys=True) == json.dumps(wm, sort_keys=True)
    assert [_bits(p) for p in gp] == [_bits(p) for p in wp]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("spec", CODECS, ids=IDS)
def test_encode_and_decode_equal_the_reference(spec, bf16):
    jcodec, tcodec = jc.get_codec(spec), tc.get_codec(spec)
    for i, shape in enumerate(SHAPES):
        j, t = _arrays(i, shape, bf16)
        want, got = jcodec.encode(j), tcodec.encode(t)
        _same_encoding(got, want)
        # the decode of the same parts, on each side
        assert _bits(tcodec.decode([p.copy() for p in got[0]], got[1])) == \
            _bits(jcodec.decode([p.copy() for p in want[0]], want[1]))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("spec", CODECS[:3], ids=IDS[:3])
def test_non_contiguous_and_zero_inputs(spec, bf16):
    jcodec, tcodec = jc.get_codec(spec), tc.get_codec(spec)
    j, t = _arrays(11, (40, 60), bf16)
    _same_encoding(tcodec.encode(t[:, ::3].T), jcodec.encode(j[:, ::3].T))
    zj, zt = np.zeros((50, 50), j.dtype), np.zeros((50, 50), t.dtype)
    got, want = tcodec.encode(zt), jcodec.encode(zj)
    _same_encoding(got, want)
    if spec[0] == "int8":
        assert got[1]["scale"] == 1.0 and not got[0][0].any()


def test_bf16_bits_widen_and_round_like_ml_dtypes():
    rng = np.random.RandomState(5)
    f = np.concatenate([
        rng.randn(4096).astype(np.float32) * 100,
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -3e38, 65504.0,
                  1.00390625, 1.01171875], np.float32),  # ties, subnormal
    ])
    want = f.astype(ml_dtypes.bfloat16)
    got = tc.narrow(f, tc.BFLOAT16)
    assert tc.is_bf16(got.dtype) and tc.dtype_str(got.dtype) == "bfloat16"
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(tc.widen(got), want.astype(np.float32))
    # torch reads the same bits as its bfloat16
    t = tc.to_torch(got)
    assert t.dtype == torch.bfloat16
    assert t.float().numpy().tobytes() == want.astype(np.float32).tobytes()
    assert tc.to_numpy(t).tobytes() == want.tobytes()


def test_dtype_names_equal_the_reference():
    for dt in (np.float32, np.float64, np.int8, np.int32, np.int64,
               np.uint16, np.float16):
        assert tc.dtype_str(dt) == jc.dtype_str(dt)
        assert tc.resolve_dtype(tc.dtype_str(dt)) == np.dtype(dt)
    assert tc.dtype_str(tc.BFLOAT16) == jc.dtype_str(ml_dtypes.bfloat16)
    assert tc.resolve_dtype("bfloat16") is tc.BFLOAT16
    # a plain uint16 is not bf16
    assert not tc.is_bf16(np.uint16) and tc.is_bf16(tc.BFLOAT16)


@pytest.mark.parametrize("spec", [
    None, "int8", "topk", "none", ("topk", {"ratio": 0.25}),
    ["int8"], ("topk", None), ("int8", {}),
])
def test_get_codec_specs(spec):
    j, t = jc.get_codec(spec), tc.get_codec(spec)
    if j is None:
        assert t is None
        return
    assert type(t).__name__ == type(j).__name__
    assert t.spec() == j.spec() and t.name == j.name
    inst = tc.Int8Codec()
    assert tc.get_codec(inst) is inst


@pytest.mark.parametrize("bad,err", [
    ("zstd", ValueError),
    (("gzip", {}), ValueError),
    (("topk", {"ratio": 0.0}), ValueError),
    (("topk", {"ratio": 1.5}), ValueError),
    (("topk", {"bogus": 1}), TypeError),
])
def test_get_codec_rejections(bad, err):
    with pytest.raises(err) as want:
        jc.get_codec(bad)
    with pytest.raises(err) as got:
        tc.get_codec(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("codec", [None, "none", tc.NoneCodec()])
def test_error_feedback_requires_a_lossy_codec(codec):
    with pytest.raises(ValueError, match="lossy codec"):
        tc.ErrorFeedback(codec)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("spec", CODECS[:2], ids=IDS[:2])
def test_error_feedback_sequence_equals_the_reference(spec, bf16):
    """20 pushes of two tensors: every encoding and the float32 residual
    after each push equal the reference's, and the decoded messages
    telescope to the sum of the true gradients."""
    jef, tef = jc.ErrorFeedback(spec), tc.ErrorFeedback(spec)
    total = {"a": 0.0, "b": 0.0}
    sent = {"a": 0.0, "b": 0.0}
    for step in range(20):
        for name, shape in (("a", (30, 20)), ("b", (700,))):
            j, t = _arrays(100 * step + len(name), shape, bf16)
            want, got = jef.encode_named(name, j), tef.encode_named(name, t)
            _same_encoding(got, want)
            assert tef._residual[name].dtype == np.float32
            assert tef._residual[name].tobytes() == \
                jef._residual[name].tobytes()
            total[name] = total[name] + tc.widen(t)
            # what the residual was computed against: the f32 decode
            sent[name] = sent[name] + tef.decode(
                got[0], dict(got[1], dtype="<f4"))
    for name in total:
        np.testing.assert_allclose(sent[name] + tef._residual[name],
                                   total[name], rtol=1e-4, atol=1e-4)
    assert tef.spec() == jef.spec() and tef.name == jef.name
    tef.reset()
    assert tef._residual == {}


def test_encoded_nbytes():
    parts, _ = tc.Int8Codec().encode(np.ones((10, 10), np.float32))
    assert tc.encoded_nbytes(parts) == jc.encoded_nbytes(parts) == 100
