"""``tf.train.Example`` wire-format codec, no tensorflow dependency (a
copy of the JAX package's ``data/example.py``).

The protobuf wire format for the tiny Example schema, by hand:

    Example   { Features features = 1; }
    Features  { map<string, Feature> feature = 1; }
    Feature   { oneof { BytesList=1; FloatList=2; Int64List=3; } }
    BytesList { repeated bytes value = 1; }
    FloatList { repeated float value = 1 [packed]; }
    Int64List { repeated int64 value = 1 [packed]; }

Output is byte-compatible with TF's encoder and with the reference's
copy.  Packed and unpacked repeated scalars are both accepted on decode.
"""

import struct

import numpy as np

_BYTES, _FLOAT, _INT64 = 1, 2, 3


# ----------------------------------------------------------------------
# varint / wire primitives
# ----------------------------------------------------------------------


def _write_varint(buf, value):
    if value < 0:
        value &= (1 << 64) - 1  # two's complement, 10 bytes
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data, pos):
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _signed64(value):
    if value >= 1 << 63:
        value -= 1 << 64
    return value


def _tag(field, wire):
    return (field << 3) | wire


def _write_len_delimited(buf, field, payload):
    _write_varint(buf, _tag(field, 2))
    _write_varint(buf, len(payload))
    buf.extend(payload)


# ----------------------------------------------------------------------
# encode
# ----------------------------------------------------------------------


def _encode_feature(kind, values):
    inner = bytearray()
    if kind == _BYTES:
        for v in values:
            _write_len_delimited(inner, 1, bytes(v))
    elif kind == _FLOAT:
        packed = np.asarray(values, dtype="<f4").tobytes()
        # TF omits an empty packed field entirely (byte-compatibility)
        if packed:
            _write_len_delimited(inner, 1, packed)
    elif kind == _INT64:
        packed = bytearray()
        for v in values:
            _write_varint(packed, int(v))
        if packed:
            _write_len_delimited(inner, 1, packed)
    else:
        raise ValueError("unknown feature kind {0}".format(kind))
    feat = bytearray()
    _write_len_delimited(feat, kind, inner)
    return feat


def encode_example(features):
    """Encode ``{name: (kind, values)}`` or ``{name: values}`` (kind
    inferred from the python/numpy types) into Example bytes."""
    feats = bytearray()
    # deterministic order → reproducible bytes (dict order suffices for
    # round-trips; sorting makes files diffable)
    for name in sorted(features):
        spec = features[name]
        if isinstance(spec, tuple) and len(spec) == 2 and spec[0] in (
            _BYTES, _FLOAT, _INT64,
        ):
            kind, values = spec
        else:
            kind, values = infer_kind(spec)
        entry = bytearray()
        _write_len_delimited(entry, 1, name.encode("utf-8"))
        _write_len_delimited(entry, 2, _encode_feature(kind, values))
        _write_len_delimited(feats, 1, entry)
    out = bytearray()
    _write_len_delimited(out, 1, feats)
    return bytes(out)


def infer_kind(values):
    """Map python/numpy values to a (kind, list) pair, following the
    reference's dtype table (dfutil.py:84-131): floats→FloatList,
    ints/bools→Int64List, str/bytes/bytearray→BytesList."""
    arr = values
    if isinstance(arr, (bytes, bytearray)):
        return _BYTES, [bytes(arr)]
    if isinstance(arr, str):
        return _BYTES, [arr.encode("utf-8")]
    if isinstance(arr, np.ndarray):
        if arr.dtype.kind == "f":
            return _FLOAT, arr.ravel().tolist()
        if arr.dtype.kind in ("i", "u", "b"):
            return _INT64, arr.ravel().astype(np.int64).tolist()
        if arr.dtype.kind in ("S", "O", "U"):
            return _BYTES, [
                v.encode("utf-8") if isinstance(v, str) else bytes(v)
                for v in arr.ravel().tolist()
            ]
        raise TypeError("unsupported array dtype {0}".format(arr.dtype))
    if not isinstance(arr, (list, tuple)):
        arr = [arr]
    if not arr:
        return _INT64, []
    first = arr[0]
    if isinstance(first, bool):
        return _INT64, [int(v) for v in arr]
    if isinstance(first, (int, np.integer)):
        return _INT64, [int(v) for v in arr]
    if isinstance(first, (float, np.floating)):
        return _FLOAT, [float(v) for v in arr]
    if isinstance(first, str):
        return _BYTES, [v.encode("utf-8") for v in arr]
    if isinstance(first, (bytes, bytearray)):
        return _BYTES, [bytes(v) for v in arr]
    raise TypeError("unsupported feature value type {0}".format(type(first)))


# ----------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------


def _decode_list(kind, data):
    values = []
    pos, end = 0, len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field != 1:
            pos = _skip(data, pos, wire)
            continue
        if kind == _BYTES:
            n, pos = _read_varint(data, pos)
            values.append(bytes(data[pos:pos + n]))
            pos += n
        elif kind == _FLOAT:
            if wire == 2:  # packed
                n, pos = _read_varint(data, pos)
                values.extend(
                    np.frombuffer(data, dtype="<f4", count=n // 4,
                                  offset=pos).tolist()
                )
                pos += n
            else:  # unpacked 32-bit
                values.append(struct.unpack_from("<f", data, pos)[0])
                pos += 4
        else:  # INT64
            if wire == 2:  # packed
                n, pos = _read_varint(data, pos)
                stop = pos + n
                while pos < stop:
                    v, pos = _read_varint(data, pos)
                    values.append(_signed64(v))
            else:
                v, pos = _read_varint(data, pos)
                values.append(_signed64(v))
    return values


def _skip(data, pos, wire):
    if wire == 0:
        _, pos = _read_varint(data, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(data, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise ValueError("unsupported wire type {0}".format(wire))
    return pos


def _decode_feature(data):
    pos, end = 0, len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field in (_BYTES, _FLOAT, _INT64) and wire == 2:
            n, pos = _read_varint(data, pos)
            return field, _decode_list(field, data[pos:pos + n])
        pos = _skip(data, pos, wire)
    return _INT64, []  # empty feature


def decode_example(data):
    """Decode Example bytes → ``{name: (kind, values)}``."""
    data = memoryview(bytes(data))
    out = {}
    pos, end = 0, len(data)
    while pos < end:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # features
            n, pos = _read_varint(data, pos)
            fend = pos + n
            while pos < fend:
                etag, pos = _read_varint(data, pos)
                if etag >> 3 != 1 or etag & 7 != 2:
                    pos = _skip(data, pos, etag & 7)
                    continue
                elen, pos = _read_varint(data, pos)
                eend = pos + elen
                name, feat = None, None
                while pos < eend:
                    ftag, pos = _read_varint(data, pos)
                    fn, fw = ftag >> 3, ftag & 7
                    if fn == 1 and fw == 2:
                        sn, pos = _read_varint(data, pos)
                        name = bytes(data[pos:pos + sn]).decode("utf-8")
                        pos += sn
                    elif fn == 2 and fw == 2:
                        vn, pos = _read_varint(data, pos)
                        feat = bytes(data[pos:pos + vn])
                        pos += vn
                    else:
                        pos = _skip(data, pos, fw)
                if name is not None:
                    out[name] = _decode_feature(feat or b"")
        else:
            pos = _skip(data, pos, wire)
    return out


KIND_BYTES, KIND_FLOAT, KIND_INT64 = _BYTES, _FLOAT, _INT64
