"""TFRecord container + tf.train.Example wire codec, dependency-free.

Reference: `python/ray/data/datasource/tfrecords_datasource.py` — the
reference parses TFRecord files of tf.train.Example protos (via
TensorFlow). TensorFlow is not a dependency here, so this module
implements the two formats directly:

- TFRecord framing: per record `uint64 length | uint32 masked-crc32c of
  the length | payload | uint32 masked-crc32c of the payload`.
- tf.train.Example protobuf wire format (the 3-level message tree:
  Example{1: Features{1: map<string, Feature{1: BytesList | 2:
  FloatList | 3: Int64List}>}}), hand-coded varint/length-delimited
  parsing — a fixed, frozen schema, so a generic proto library buys
  nothing.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

import numpy as np

# --- crc32c (Castagnoli), table-driven -----------------------------------

_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# --- TFRecord framing -----------------------------------------------------

def read_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            data = f.read(length)
            f.read(4)  # data crc (not verified, reference-compatible)
            if len(data) < length:
                return
            yield data


def write_records(path: str, payloads: List[bytes]) -> None:
    with open(path, "wb") as f:
        for data in payloads:
            length = struct.pack("<Q", len(data))
            f.write(length)
            f.write(struct.pack("<I", _masked_crc(length)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))


# --- minimal proto wire ---------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _fields(buf: bytes) -> Iterator[tuple]:
    """Yield (field_number, wire_type, value) over one message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            n, pos = _read_varint(buf, pos)
            value = buf[pos:pos + n]
            pos += n
        elif wire == 5:  # fixed32
            value = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:  # fixed64
            value = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def parse_example(data: bytes) -> Dict[str, Any]:
    """tf.train.Example bytes -> {feature_name: list | np.ndarray}."""
    out: Dict[str, Any] = {}
    for field, _, features_buf in _fields(data):
        if field != 1:  # Example.features
            continue
        for f2, _, entry in _fields(features_buf):
            if f2 != 1:  # Features.feature map entry
                continue
            name, feature = None, b""
            for f3, _, v in _fields(entry):
                if f3 == 1:
                    name = v.decode()
                elif f3 == 2:
                    feature = v
            if name is None:
                continue
            for kind, wire, payload in _fields(feature):
                if kind == 1:  # BytesList
                    out[name] = [v for f4, _, v in _fields(payload)
                                 if f4 == 1]
                elif kind == 2:  # FloatList (packed fixed32)
                    vals = []
                    for f4, w4, v in _fields(payload):
                        if f4 != 1:
                            continue
                        if w4 == 2:  # packed
                            vals.extend(np.frombuffer(v, "<f4"))
                        else:
                            vals.append(
                                struct.unpack("<f", v)[0])
                    out[name] = np.asarray(vals, np.float32)
                elif kind == 3:  # Int64List (packed varint)
                    vals = []
                    for f4, w4, v in _fields(payload):
                        if f4 != 1:
                            continue
                        if w4 == 2:
                            pos = 0
                            while pos < len(v):
                                x, pos = _read_varint(v, pos)
                                vals.append(_to_signed(x))
                        else:
                            vals.append(_to_signed(v))
                    out[name] = np.asarray(vals, np.int64)
    return out


def _to_signed(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


def _delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, field << 3 | 2)
    _write_varint(out, len(payload))
    out.extend(payload)


def build_example(row: Dict[str, Any]) -> bytes:
    """{name: value(s)} -> tf.train.Example bytes. int -> Int64List,
    float -> FloatList, bytes/str -> BytesList."""
    features = bytearray()
    for name, value in row.items():
        vals = np.atleast_1d(np.asarray(value)) \
            if not isinstance(value, (bytes, str, list)) else (
                value if isinstance(value, list) else [value])
        feature = bytearray()
        first = vals[0]
        if isinstance(first, (bytes, str)):
            blist = bytearray()
            for v in vals:
                _delimited(blist, 1,
                           v.encode() if isinstance(v, str) else v)
            _delimited(feature, 1, bytes(blist))
        elif np.issubdtype(np.asarray(first).dtype, np.floating):
            packed = np.asarray(vals, "<f4").tobytes()
            flist = bytearray()
            _delimited(flist, 1, packed)
            _delimited(feature, 2, bytes(flist))
        else:
            body = bytearray()
            for v in vals:
                x = int(v)
                _write_varint(body, x + (1 << 64) if x < 0 else x)
            ilist = bytearray()
            _delimited(ilist, 1, bytes(body))
            _delimited(feature, 3, bytes(ilist))
        entry = bytearray()
        _delimited(entry, 1, name.encode())
        _delimited(entry, 2, bytes(feature))
        _delimited(features, 1, bytes(entry))
    example = bytearray()
    _delimited(example, 1, bytes(features))
    return bytes(example)
