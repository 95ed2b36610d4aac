"""ctypes bindings of the repository's C++ XTC codec.

The codec source is ``molar_tpu/native/xtc_codec.cpp``, located by path and
built by :mod:`molar_tpu_torch.build`; the argtypes are those of
``molar_tpu.native.load``.
"""

from __future__ import annotations

import ctypes
import functools

from . import build


@functools.cache
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build_codec()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i16p = ctypes.POINTER(ctypes.c_int16)
    longp = ctypes.POINTER(ctypes.c_long)

    lib.xtc_parse_header.restype = ctypes.c_int
    lib.xtc_parse_header.argtypes = [u8p, ctypes.c_long, i32p, i32p, f32p, f32p, longp]
    lib.xtc_decode_frame_buf.restype = ctypes.c_int
    lib.xtc_decode_frame_buf.argtypes = [u8p, ctypes.c_long, f32p, f32p, i32p, f32p, f32p]
    lib.xtc_decode_frame_detect.restype = ctypes.c_int
    lib.xtc_decode_frame_detect.argtypes = [
        u8p, ctypes.c_long, f32p, f32p, i32p, f32p, f32p, i32p,
    ]
    lib.xtc_decode_frame_prefix.restype = ctypes.c_int
    lib.xtc_decode_frame_prefix.argtypes = [
        u8p, ctypes.c_long, f32p, ctypes.c_int32, f32p, i32p, f32p, ctypes.c_int32,
    ]
    lib.xtc_decode_frame_buf_i16.restype = ctypes.c_int
    lib.xtc_decode_frame_buf_i16.argtypes = [
        u8p, ctypes.c_long, i16p, f32p, i32p, f32p, f32p,
    ]
    lib.xtc_decode_frame_prefix_i16.restype = ctypes.c_int
    lib.xtc_decode_frame_prefix_i16.argtypes = [
        u8p, ctypes.c_long, i16p, ctypes.c_int32, f32p, i32p, f32p, f32p,
        ctypes.c_int32,
    ]
    lib.xtc_encode_frame.restype = ctypes.c_long
    lib.xtc_encode_frame.argtypes = [
        f32p, ctypes.c_int, f32p, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(u8p),
    ]
    lib.xtc_free.restype = None
    lib.xtc_free.argtypes = [u8p]
    lib.xtc_index.restype = ctypes.c_long
    lib.xtc_index.argtypes = [u8p, ctypes.c_long, longp, i32p, f32p, ctypes.c_long, i32p]
    return lib
