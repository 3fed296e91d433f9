"""The port's row interchange (``data/interchange``) and filesystem
helpers (``utils/fs``) against the JAX package's, on the CPU.

The same rows and schemas go to both packages: schema strings must parse
and format alike, inferred schemas and wire specs must be equal, shards
must be byte for byte the reference's (local and ``memory://``), each
package must read the other's files back to equal rows, and errors must
be of the same class with the same message.
"""

import os
import sys
import uuid

import numpy as np
import pytest

from tensorflowonspark_tpu.data import example as jex
from tensorflowonspark_tpu.data import interchange as jic
from tensorflowonspark_tpu.utils import fs as jfs
from tensorflowonspark_tpu_torch.data import example as tex
from tensorflowonspark_tpu_torch.data import interchange as tic
from tensorflowonspark_tpu_torch.utils import fs as tfs

ROWS = [
    {"idx": i, "feat": [float(i), i + 0.5], "tag": "row%d" % i,
     "raw": bytes([i, i + 1]), "flag": i % 2 == 0, "small": i % 5,
     "tokens": np.arange(6, dtype=np.int32) + i}
    for i in range(20)
]
SCHEMA = [
    ("idx", "long"), ("feat", "array<float>"), ("tag", "string"),
    ("raw", "binary"), ("flag", "boolean"), ("small", "ubyte"),
    ("tokens", "array<int>"),
]

SCHEMA_TEXTS = [
    "struct<a:int,b:array<float>,c:string,d:binary>",
    "struct< a : long , b : array< double > >",
    "struct<x:short,y:byte,z:ubyte,w:boolean>",
    "struct<only:array<ubyte>>",
]
BAD_SCHEMA_TEXTS = [
    "struct<a:complex>",
    "a:int,b:float",
    "struct<>",
    "struct<a>",
    "struct<a:array<map>>",
]


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, KeyError, FileNotFoundError) as e:
        return ("raise", type(e).__name__, str(e))


@pytest.mark.parametrize("text", SCHEMA_TEXTS + BAD_SCHEMA_TEXTS)
def test_parse_and_format_schema_match_jax(text):
    want = _outcome(lambda: jic.parse_schema(text))
    got = _outcome(lambda: tic.parse_schema(text))
    assert got == want
    if got[0] == "ok":
        assert tic.format_schema(got[1]) == jic.format_schema(want[1])
        assert tic.parse_schema(tic.format_schema(got[1])) == got[1]


def test_type_tables_match_jax():
    assert tic.SCALAR_TYPES == jic.SCALAR_TYPES
    assert tic.WIRE_DTYPE_OF_BASE == jic.WIRE_DTYPE_OF_BASE


@pytest.mark.parametrize("binary", [(), ("raw",), ("raw", "tag")])
def test_infer_schema_matches_jax(binary):
    record = tex.encode_example({k: v for k, v in ROWS[3].items()})
    assert record == jex.encode_example(dict(ROWS[3]))
    assert (tic.infer_schema(tex.decode_example(record), binary)
            == jic.infer_schema(jex.decode_example(record), binary))


@pytest.mark.parametrize("schema", [SCHEMA, "struct<a:ubyte,b:array<short>,"
                                             "c:string,d:double,e:boolean>"])
def test_schema_wire_spec_matches_jax(schema):
    assert tic.schema_wire_spec(schema).dtypes == \
        jic.schema_wire_spec(schema).dtypes


@pytest.mark.parametrize("schema", [None, SCHEMA])
def test_row_to_example_bytes_equal(schema):
    for row in ROWS[:5]:
        assert tic.row_to_example(row, schema) == \
            jic.row_to_example(row, schema)


def _shards(path):
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("num_shards", [1, 3])
@pytest.mark.parametrize("schema", [None, SCHEMA])
def test_shards_byte_identical_and_cross_read(tmp_path, num_shards, schema):
    paths = {}
    for name, mod in (("jax", jic), ("torch", tic)):
        paths[name] = str(tmp_path / name)
        assert mod.save_as_tfrecords(ROWS, paths[name], schema,
                                     num_shards=num_shards) == len(ROWS)
    assert len(_shards(paths["torch"])) == num_shards
    assert _shards(paths["torch"]) == _shards(paths["jax"])
    read_schema = schema if schema is not None else None
    want = jic.load_tfrecords(paths["jax"], schema=read_schema)
    for path in paths.values():
        got = tic.load_tfrecords(path, schema=read_schema)
        assert got == want
    # the reference reads the port's shards to the same rows
    assert jic.load_tfrecords(paths["torch"], schema=read_schema) == want


def test_schema_string_on_save_writes_the_listed_schemas_bytes(tmp_path):
    """The port's ``save_as_tfrecords`` also takes a ``struct<...>``
    string: its shards are the reference's for the parsed list."""
    text = jic.format_schema(SCHEMA)
    tic.save_as_tfrecords(ROWS, str(tmp_path / "t"), text, num_shards=2)
    jic.save_as_tfrecords(ROWS, str(tmp_path / "j"), SCHEMA, num_shards=2)
    assert _shards(str(tmp_path / "t")) == _shards(str(tmp_path / "j"))


def test_loaded_rows_equal_the_saved_rows(tmp_path):
    path = str(tmp_path / "out")
    tic.save_as_tfrecords(ROWS, path, SCHEMA, num_shards=3)
    rows, schema = tic.load_tfrecords(path, schema=SCHEMA)
    assert schema == SCHEMA
    rows.sort(key=lambda r: r["idx"])
    for got, want in zip(rows, ROWS):
        assert (got["idx"], got["tag"], got["raw"], got["flag"],
                got["small"]) == (want["idx"], want["tag"], want["raw"],
                                  want["flag"], want["small"])
        np.testing.assert_allclose(got["feat"], want["feat"], rtol=1e-6)
        assert got["tokens"] == want["tokens"].tolist()


@pytest.mark.parametrize("binary", [(), ("raw",)])
def test_binary_features_hint_matches_jax(tmp_path, binary):
    path = str(tmp_path / "out")
    tic.save_as_tfrecords(ROWS, path, SCHEMA)
    got_rows, got = tic.load_tfrecords(path, binary_features=binary)
    want_rows, want = jic.load_tfrecords(path, binary_features=binary)
    assert got == want and got_rows == want_rows
    assert dict(got)["raw"] == ("binary" if binary else "string")
    # inference sees int64 on the wire for booleans
    assert dict(got)["flag"] == "long"


def test_schema_string_accepted(tmp_path):
    path = str(tmp_path / "out")
    tic.save_as_tfrecords([{"x": 1, "y": 2.0}], path,
                          [("x", "long"), ("y", "double")])
    rows, _ = tic.load_tfrecords(path, schema="struct<x:long,y:double>")
    assert rows == [{"x": 1, "y": 2.0}]


def test_missing_fields_on_read_match_jax(tmp_path):
    path = str(tmp_path / "out")
    tic.save_as_tfrecords([{"x": 1}], path)
    schema = [("x", "long"), ("gone", "array<int>"), ("none", "string")]
    assert tic.load_tfrecords(path, schema) == jic.load_tfrecords(path,
                                                                 schema)


@pytest.mark.parametrize("case", ["missing_field", "empty_dir"])
def test_errors_match_jax(tmp_path, case):
    def run(mod, sub):
        path = str(tmp_path / sub)
        if case == "missing_field":
            return mod.save_as_tfrecords([{"x": 1}], path, [("y", "long")])
        os.makedirs(path)
        open(os.path.join(path, "_SUCCESS"), "w").close()
        return mod.load_tfrecords(path)

    want = _outcome(lambda: run(jic, "j"))
    got = _outcome(lambda: run(tic, "t"))
    assert want[0] == "raise"
    assert got[:2] == want[:2]
    assert got[2].replace(str(tmp_path / "t"), "") == \
        want[2].replace(str(tmp_path / "j"), "")


def test_record_files_skip_hidden_and_markers(tmp_path):
    path = tmp_path / "d"
    tic.save_as_tfrecords(ROWS, str(path), num_shards=2)
    (path / "_SUCCESS").write_bytes(b"")
    (path / ".part-r-00000.crc").write_bytes(b"")
    assert tic._record_files(str(path)) == jic._record_files(str(path))
    assert [os.path.basename(f) for f in tic._record_files(str(path))] == \
        ["part-r-00000", "part-r-00001"]
    single = str(path / "part-r-00000")
    assert tic._record_files(single) == [single]


def test_memory_uri_round_trip_matches_jax():
    fsspec = pytest.importorskip("fsspec")
    root = "memory://tfos-interchange-" + uuid.uuid4().hex
    fs = fsspec.filesystem("memory")
    try:
        for name, mod in (("jax", jic), ("torch", tic)):
            mod.save_as_tfrecords(ROWS, root + "/" + name, SCHEMA,
                                  num_shards=2)
        for i in range(2):
            shard = "/part-r-{0:05d}".format(i)
            assert fs.cat(root + "/torch" + shard) == \
                fs.cat(root + "/jax" + shard)
        want = jic.load_tfrecords(root + "/jax", SCHEMA)
        assert tic.load_tfrecords(root + "/jax", SCHEMA) == want
        assert tic.load_tfrecords(root + "/torch", SCHEMA) == want
    finally:
        fs.rm(root, recursive=True)


# --- utils/fs --------------------------------------------------------------

FS_PATHS = ["/tmp/a/b", "relative/x", "file:///tmp/a", "file://tmp/a",
            "gs://bucket/key/", "memory://x/y", "C://not-a-scheme",
            "hdfs://nn:8020/data/part-0"]


@pytest.mark.parametrize("path", FS_PATHS)
def test_fs_path_functions_match_jax(path):
    for fn in ("split_scheme", "is_remote", "basename"):
        assert getattr(tfs, fn)(path) == getattr(jfs, fn)(path), fn
    assert tfs.join(path, "c", "d") == jfs.join(path, "c", "d")
    assert _outcome(lambda: tfs.local_path(path)) == \
        _outcome(lambda: jfs.local_path(path))


def test_fs_local_operations_match_jax(tmp_path):
    base = str(tmp_path / "x" / "y")
    tfs.makedirs(base)
    assert tfs.exists(base) and tfs.isdir(base)
    with tfs.open_file(os.path.join(base, "f"), "wb") as f:
        f.write(b"payload")
    (tmp_path / "x" / "y" / ".hidden").write_bytes(b"")
    os.makedirs(os.path.join(base, "sub"))
    assert tfs.list_files(base) == jfs.list_files(base)
    assert tfs.list_files("file://" + base) == jfs.list_files("file://" + base)
    with tfs.open_file("file://" + os.path.join(base, "f")) as f:
        assert f.read() == b"payload"
    assert not tfs.isdir(os.path.join(base, "f"))
    assert not tfs.exists(os.path.join(base, "nope"))


def test_fs_remote_operations_match_jax():
    pytest.importorskip("fsspec")
    root = "memory://tfos-fs-" + uuid.uuid4().hex
    try:
        tfs.makedirs(root + "/d")
        with tfs.open_file(root + "/d/f1", "wb") as f:
            f.write(b"one")
        with jfs.open_file(root + "/d/f0", "wb") as f:
            f.write(b"zero")
        assert tfs.exists(root + "/d/f0") and tfs.isdir(root + "/d")
        assert tfs.list_files(root + "/d") == jfs.list_files(root + "/d")
        assert [tfs.basename(f) for f in tfs.list_files(root + "/d")] == \
            ["f0", "f1"]
        with tfs.open_file(root + "/d/f0") as f:
            assert f.read() == b"zero"
    finally:
        import fsspec

        fsspec.filesystem("memory").rm(root, recursive=True)


def test_fs_remote_without_fsspec_raises_like_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "fsspec", None)
    for mod in (tfs, jfs):
        with pytest.raises(ImportError, match="fsspec is required"):
            mod.exists("gs://bucket/key")
    assert tfs.exists("/") and tfs.list_files("/") == jfs.list_files("/")
