"""The port's narrow-dtype wire plane and TFRecord/Example codecs against
the JAX package's, on the CPU: ``narrow_cast``, ``WireSpec``,
``decode_batch`` (the native codec that ``data/_native`` builds from
``native/example_codec.cc``, and the pure-Python path), the Example
encoder, TFRecord files (native and Python framing) and
``load_tfrecords_columnar``.  The same numpy inputs go to both
packages; outputs must be equal exactly, dtypes included, files byte for
byte, and where the reference raises the port raises the same error
class with the same message."""

import os
import sys
import uuid

import numpy as np
import pytest

from tensorflowonspark_tpu.data import columnar as jcol
from tensorflowonspark_tpu.data import example as jex
from tensorflowonspark_tpu.data import tfrecord as jtfr
from tensorflowonspark_tpu_torch.data import _native
from tensorflowonspark_tpu_torch.data import columnar as tcol
from tensorflowonspark_tpu_torch.data import example as tex
from tensorflowonspark_tpu_torch.data import tfrecord as ttfr
from test_torch_feed import assert_same

COLUMNAR = {"jax": jcol, "torch": tcol}
TFRECORD = {"jax": jtfr, "torch": ttfr}


def _outcome(fn):
    """``("ok", value)`` or ``("raise", class name, message)``."""
    try:
        return ("ok", fn())
    except (ValueError, TypeError, KeyError, IndexError) as e:
        return ("raise", type(e).__name__, str(e))


def assert_same_outcome(fn_of_package):
    want = _outcome(lambda: fn_of_package("jax"))
    got = _outcome(lambda: fn_of_package("torch"))
    assert_same(got, want)
    return got


# --- narrow_cast and WireSpec --------------------------------------------

#: name -> (values, wire dtype, whether the cast must raise)
NARROW_CASES = {
    "uint8_in_range": (np.array([0, 17, 255]), "uint8", False),
    "uint8_out_of_range": (np.array([0, 300]), "uint8", True),
    "int8_negative": (np.array([-128, 5, 127]), "int8", False),
    "int16_out_of_range": (np.array([-40000]), "int16", True),
    "uint16_tokens": (np.arange(31990, 32000, dtype=np.int64), "uint16",
                      False),
    "uint16_negative": (np.array([-1, 5]), "uint16", True),
    "int32_from_int64": (np.array([2 ** 31 - 1, -2 ** 31]), "int32", False),
    "float16_lossy": (np.array([0.1, 65504.0, 1e-8]), "float16", False),
    "same_dtype": (np.array([1, 2], np.uint8), "uint8", False),
    "empty": (np.zeros((0, 3), np.int64), "uint8", False),
}


@pytest.mark.parametrize("case", sorted(NARROW_CASES))
def test_narrow_cast_matches_jax(case):
    arr, dtype, raises = NARROW_CASES[case]
    got = assert_same_outcome(
        lambda p: COLUMNAR[p].narrow_cast(arr.copy(), dtype))
    assert (got[0] == "raise") == raises


def test_wirespec_matches_jax():
    x = np.random.RandomState(0).randint(0, 256, (16, 28, 28))

    def run(p):
        spec = COLUMNAR[p].WireSpec({"image": "uint8", "label": "int32"})
        cols = spec.narrow({"image": x, "label": np.arange(16),
                            "other": np.ones(2)})
        tup = COLUMNAR[p].WireSpec({0: "uint8"}).narrow(
            (np.array([1, 2, 255]), np.array([1.5, 2.5])))
        rows = spec.narrow_rows([{"image": np.array([i, 2 * i]), "y": i}
                                 for i in range(3)])
        return (cols, tup, rows, COLUMNAR[p].WireSpec.wire_bytes(cols),
                COLUMNAR[p].WireSpec.wire_bytes(tup))

    got = assert_same_outcome(run)
    assert got[1][0]["image"].dtype == np.uint8
    assert got[1][3] == 16 * 28 * 28 + 16 * 4 + 2 * 8


def test_wirespec_refuses_out_of_range_rows():
    got = assert_same_outcome(lambda p: COLUMNAR[p].WireSpec(
        {"tokens": "uint16"}).narrow_rows([{"tokens": np.array([70000])}]))
    assert got[0] == "raise"


# --- the Example codec -----------------------------------------------------

EXAMPLE_CASES = {
    "ints": {"tokens": np.arange(-3, 300, dtype=np.int64)},
    "floats": {"f": np.linspace(-1, 1, 7).astype(np.float32)},
    "bytes_and_str": {"b": b"\x00\xff", "s": "text", "l": ["a", "bc"]},
    "mixed_kinds": {"label": 3, "score": 0.25, "flag": True,
                    "img": np.arange(12, dtype=np.uint8).reshape(3, 4)},
    "explicit_kind_empty": {"e": (jex.KIND_INT64, []),
                            "g": (jex.KIND_FLOAT, [])},
    "large_varints": {"v": [2 ** 62, -(2 ** 62), -1, 0]},
}


@pytest.mark.parametrize("case", sorted(EXAMPLE_CASES))
def test_example_bytes_equal_and_decode_across(case):
    feats = EXAMPLE_CASES[case]
    mine, ref = tex.encode_example(feats), jex.encode_example(feats)
    assert mine == ref
    assert_same(tex.decode_example(ref), jex.decode_example(mine))
    for v in feats.values():
        if not (isinstance(v, tuple) and len(v) == 2):
            assert_same(tex.infer_kind(v), jex.infer_kind(v))


# --- decode_batch -------------------------------------------------------


def _example_records(n=6, width=8, seed=0):
    rng = np.random.RandomState(seed)
    return [tex.encode_example({
        "feat": (tex.KIND_FLOAT, rng.rand(width).astype(np.float32).tolist()),
        "label": (tex.KIND_INT64, [int(rng.randint(0, 10))]),
        "tokens": (tex.KIND_INT64, rng.randint(0, 32000, width).tolist()),
        "pix": (tex.KIND_INT64, rng.randint(0, 256, width).tolist()),
        "big": (tex.KIND_INT64, [70000] * width),
        "neg": (tex.KIND_INT64, rng.randint(-3, 3, width).tolist()),
    }) for _ in range(n)]


DECODE_CASES = {
    "proto_kinds": {"feat": ("float32", 8), "label": ("int64", 1)},
    "narrow_uint16_tokens": {"tokens": ("uint16", 8)},
    "narrow_uint8_and_int16": {"pix": ("uint8", 8), "neg": ("int16", 8)},
    "narrow_int32_and_float16": {"tokens": ("int32", 8),
                                 "feat": ("float16", 8)},
    "out_of_range_uint16": {"big": ("uint16", 8)},
    "negative_into_uint8": {"neg": ("uint8", 8)},
    "missing_feature": {"nope": ("float32", 8)},
    "width_mismatch": {"feat": ("float32", 5)},
    "kind_mismatch": {"feat": ("int64", 8)},
    "unsupported_dtype": {"feat": ("float64", 8)},
}


@pytest.fixture(params=["native", "python"])
def codec_path(request, monkeypatch):
    """Both packages on their native codec, or both on the Python path."""
    if request.param == "python":
        for mod in COLUMNAR.values():
            monkeypatch.setattr(mod, "_load_native", lambda: None)
    else:
        assert tcol._load_native() is not None
    return request.param


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_batch_matches_jax(codec_path, case):
    recs = _example_records()
    got = assert_same_outcome(
        lambda p: COLUMNAR[p].decode_batch(recs, DECODE_CASES[case]))
    errors = ("out_of_range", "negative", "missing", "mismatch",
              "unsupported")
    assert (got[0] == "raise") == any(e in case for e in errors)


def test_decode_batch_malformed_proto_raises_like_jax(codec_path):
    got = assert_same_outcome(lambda p: COLUMNAR[p].decode_batch(
        [b"\xff\xff\xff"], {"feat": ("float32", 2)}))
    assert got[0] == "raise"


def test_native_codec_is_built_in_the_port_build_dir():
    assert tcol._load_native() is not None
    path = _native.loaded()["libexample_codec.so"]
    assert path.startswith(_native.BUILD_DIR)
    assert path == _native.library_path("libexample_codec.so")
    assert _native.source_path("libexample_codec.so") == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "native", "example_codec.cc")


# --- TFRecord files ------------------------------------------------------


@pytest.fixture(params=["native", "python"])
def framing(request, monkeypatch):
    """Both packages on the native TFRecord codec, or both framing in
    Python."""
    if request.param == "python":
        for mod in TFRECORD.values():
            monkeypatch.setattr(mod, "_load_native", lambda: None)
    else:
        assert ttfr.native_available()
    return request.param


def test_crc_matches_jax(framing):
    rng = np.random.RandomState(1)
    for n in (0, 1, 7, 64, 1000):
        data = rng.bytes(n)
        assert ttfr.crc32c(data) == jtfr.crc32c(data)
        assert ttfr.masked_crc(data) == jtfr.masked_crc(data)
    assert ttfr.crc32c(b"123456789") == 0xE3069283  # the CRC32C check value


def test_write_records_bytes_equal_and_read_across(framing, tmp_path):
    recs = [tex.encode_example({"tokens": np.arange(i, i + 50)})
            for i in range(20)] + [b"", b"\x00" * 3]
    paths = {}
    for p in ("jax", "torch"):
        paths[p] = str(tmp_path / (p + ".tfrecord"))
        assert TFRECORD[p].write_records(paths[p], recs) == len(recs)
    with open(paths["jax"], "rb") as f, open(paths["torch"], "rb") as g:
        assert f.read() == g.read()
    assert list(ttfr.read_records(paths["jax"])) == recs
    assert list(jtfr.read_records(paths["torch"])) == recs
    assert list(ttfr.read_records("file://" + paths["jax"])) == recs


def test_corrupt_record_raises_like_jax(framing, tmp_path):
    path = str(tmp_path / "bad.tfrecord")
    ttfr.write_records(path, [b"payload-one", b"payload-two"])
    with open(path, "r+b") as f:
        f.seek(14)
        f.write(b"X")
    for mod in (ttfr, jtfr):
        with pytest.raises(mod.CorruptRecordError):
            list(mod.read_records(path))


def test_remote_uris_are_refused(monkeypatch):
    """Without ``fsspec`` a remote URI raises the reference's
    ``ImportError`` in both packages (local paths need no ``fsspec``)."""
    monkeypatch.setitem(sys.modules, "fsspec", None)
    for mod in (ttfr, jtfr):
        with pytest.raises(ImportError, match="fsspec is required"):
            mod.TFRecordWriter("gs://bucket/x.tfrecord")
        with pytest.raises(ImportError, match="fsspec is required"):
            list(mod.read_records("memory://bucket/x.tfrecord"))


def test_remote_uris_round_trip_through_fsspec():
    """A ``memory://`` URI goes through ``fsspec`` with the Python
    framing: the port's file is byte for byte the reference's, and each
    package reads the other's."""
    fsspec = pytest.importorskip("fsspec")
    recs = [b"", b"alpha", bytes(range(256)) * 3]
    root = "memory://tfos-dataplane-" + uuid.uuid4().hex
    try:
        paths = {}
        for p in ("jax", "torch"):
            paths[p] = root + "/" + p + ".tfrecord"
            assert TFRECORD[p].write_records(paths[p], recs) == len(recs)
        fs = fsspec.filesystem("memory")
        assert fs.cat(paths["jax"]) == fs.cat(paths["torch"])
        assert list(ttfr.read_records(paths["jax"])) == recs
        assert list(jtfr.read_records(paths["torch"])) == recs
    finally:
        fsspec.filesystem("memory").rm(root, recursive=True)


def test_load_tfrecords_columnar_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 32000, (24, 16))
    shards = tmp_path / "shards"
    shards.mkdir()
    for i in range(3):
        ttfr.write_records(str(shards / "part-{0:05d}".format(i)), [
            tex.encode_example({"tokens": row, "label": int(row[0] % 7)})
            for row in tokens[i * 8:(i + 1) * 8]])
    (shards / "_SUCCESS").write_bytes(b"")
    (shards / ".part-00000.crc").write_bytes(b"not a record file")
    columns = {"tokens": ("uint16", 16), "label": ("int64", 1)}
    for path in (str(shards), str(shards / "part-00001")):
        got = assert_same_outcome(
            lambda p: COLUMNAR[p].load_tfrecords_columnar(path, columns))
        assert got[1]["tokens"].dtype == np.uint16
    assert (got[1]["tokens"] == tokens[8:16]).all()
    full = tcol.load_tfrecords_columnar(str(shards), columns)
    assert (full["tokens"] == tokens).all()
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tcol.load_tfrecords_columnar(str(empty), columns)
