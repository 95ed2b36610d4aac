"""Minimal ONNX loader: protobuf wire-format parser + tensor extraction.

The port's own copy of ``molar_tpu.ff.onnx_mini`` (numpy only): the espaloma
charge model (``molar_tpu/ff/espaloma_charge.onnx``, ~600 KB) is decoded
directly, by a ~150-line protobuf wire parser (varints and length-delimited
fields against the public ONNX schema field numbers), and run by
:mod:`molar_tpu_torch.ff.espaloma`. No onnx/onnxruntime dependency.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fieldno = key >> 3
        wtype = key & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fieldno, wtype, val


# ONNX TensorProto data types (subset)
_DTYPES = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_, 11: np.float64}


@dataclass
class Tensor:
    name: str = ""
    dims: tuple = ()
    data: Optional[np.ndarray] = None


def parse_tensor(buf: memoryview) -> Tensor:
    t = Tensor()
    dims = []
    dtype = np.float32
    raw = None
    float_data = []
    int64_data = []
    int32_data = []
    for fno, wt, val in iter_fields(buf):
        if fno == 1 and wt == 0:  # dims
            dims.append(val)
        elif fno == 2 and wt == 0:  # data_type
            dtype = _DTYPES.get(val, np.float32)
        elif fno == 4:  # float_data (packed or single)
            if wt == 2:
                float_data.extend(struct.unpack(f"<{len(val) // 4}f", bytes(val)))
            else:
                float_data.append(struct.unpack("<f", bytes(val))[0])
        elif fno == 5 and wt == 2:  # int32_data packed
            pos = 0
            while pos < len(val):
                v, pos = _read_varint(val, pos)
                int32_data.append(v)
        elif fno == 7:  # int64_data
            if wt == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int64_data.append(v)
            else:
                int64_data.append(val)
        elif fno == 8 and wt == 2:  # name
            t.name = bytes(val).decode()
        elif fno == 9 and wt == 2:  # raw_data
            raw = bytes(val)
    t.dims = tuple(dims)
    if raw is not None:
        t.data = np.frombuffer(raw, dtype=dtype).reshape(t.dims)
    elif float_data:
        t.data = np.asarray(float_data, dtype=np.float32).reshape(t.dims)
    elif int64_data:
        t.data = np.asarray(int64_data, dtype=np.int64).reshape(t.dims)
    elif int32_data:
        t.data = np.asarray(int32_data, dtype=np.int32).reshape(t.dims)
    else:
        t.data = np.zeros(t.dims, dtype=dtype)
    return t


@dataclass
class Attribute:
    name: str = ""
    f: Optional[float] = None
    i: Optional[int] = None
    s: Optional[bytes] = None
    t: Optional[Tensor] = None
    floats: list = field(default_factory=list)
    ints: list = field(default_factory=list)


def parse_attribute(buf: memoryview) -> Attribute:
    a = Attribute()
    for fno, wt, val in iter_fields(buf):
        if fno == 1 and wt == 2:
            a.name = bytes(val).decode()
        elif fno == 2:
            a.f = struct.unpack("<f", bytes(val))[0]
        elif fno == 3 and wt == 0:
            a.i = val
        elif fno == 4 and wt == 2:
            a.s = bytes(val)
        elif fno == 5 and wt == 2:
            a.t = parse_tensor(val)
        elif fno == 7:
            if wt == 2:
                a.floats.extend(struct.unpack(f"<{len(val) // 4}f", bytes(val)))
            else:
                a.floats.append(struct.unpack("<f", bytes(val))[0])
        elif fno == 8:
            if wt == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    a.ints.append(v)
            else:
                a.ints.append(val)
    return a


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    attrs: dict = field(default_factory=dict)


def parse_node(buf: memoryview) -> Node:
    n = Node()
    for fno, wt, val in iter_fields(buf):
        if fno == 1 and wt == 2:
            n.inputs.append(bytes(val).decode())
        elif fno == 2 and wt == 2:
            n.outputs.append(bytes(val).decode())
        elif fno == 3 and wt == 2:
            n.name = bytes(val).decode()
        elif fno == 4 and wt == 2:
            n.op_type = bytes(val).decode()
        elif fno == 5 and wt == 2:
            a = parse_attribute(val)
            n.attrs[a.name] = a
    return n


@dataclass
class Graph:
    nodes: list = field(default_factory=list)
    initializers: dict = field(default_factory=dict)
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)


def parse_graph(buf: memoryview) -> Graph:
    g = Graph()
    for fno, wt, val in iter_fields(buf):
        if fno == 1 and wt == 2:  # node
            g.nodes.append(parse_node(val))
        elif fno == 5 and wt == 2:  # initializer
            t = parse_tensor(val)
            g.initializers[t.name] = t.data
        elif fno == 11 and wt == 2:  # input (ValueInfoProto)
            for f2, w2, v2 in iter_fields(val):
                if f2 == 1 and w2 == 2:
                    g.inputs.append(bytes(v2).decode())
        elif fno == 12 and wt == 2:  # output
            for f2, w2, v2 in iter_fields(val):
                if f2 == 1 and w2 == 2:
                    g.outputs.append(bytes(v2).decode())
    return g


def load_model(path: str) -> Graph:
    """Parse an .onnx file -> Graph (ModelProto field 7 = graph)."""
    data = memoryview(open(path, "rb").read())
    for fno, wt, val in iter_fields(data):
        if fno == 7 and wt == 2:
            return parse_graph(val)
    raise ValueError(f"no graph found in {path}")
