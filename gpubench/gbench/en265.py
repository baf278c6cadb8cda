"""ctypes binding of the in-repo HEVC encoder (the en265 C API of
``build/libtde265.so``), the benchmark's load generator.

A frozen copy of the encoder part of ``libde265_tpu_torch/encoder.py``
(itself a copy of ``libde265_tpu/encoder.py``), trimmed to 8-bit 4:2:0, so
that a change to the program's bindings cannot change the streams the
benchmark decodes.  It loads the library the native build leaves in
``build/`` and builds nothing itself.
"""
from __future__ import annotations

import ctypes as ct
from pathlib import Path

import numpy as np


class _Packet(ct.Structure):
    _fields_ = [
        ("version", ct.c_int),
        ("data", ct.POINTER(ct.c_uint8)),
        ("length", ct.c_int),
        ("frame_number", ct.c_int),
        ("content_type", ct.c_int),
        ("complete_picture", ct.c_char),
        ("final_slice", ct.c_char),
        ("dependent_slice", ct.c_char),
        ("pts", ct.c_int64),
        ("user_data", ct.c_void_p),
        ("input_image", ct.c_void_p),
        ("reconstruction", ct.c_void_p),
    ]


def load(lib_path: Path) -> ct.CDLL:
    """The native library at `lib_path` with the en265 entry points typed."""
    L = ct.CDLL(str(lib_path))
    L.en265_new_encoder.restype = ct.c_void_p
    L.en265_free_encoder.argtypes = [ct.c_void_p]
    L.en265_start_encoder.argtypes = [ct.c_void_p, ct.c_int]
    L.en265_set_parameter_int.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_int]
    L.en265_set_parameter_bool.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_int]
    L.en265_set_parameter_choice.argtypes = [ct.c_void_p, ct.c_char_p,
                                             ct.c_char_p]
    L.en265_allocate_image.restype = ct.c_void_p
    L.en265_allocate_image.argtypes = [ct.c_void_p, ct.c_int, ct.c_int,
                                       ct.c_int, ct.c_int64, ct.c_void_p]
    L.en265_get_image_plane.restype = ct.c_void_p
    L.en265_get_image_plane.argtypes = [ct.c_void_p, ct.c_int,
                                        ct.POINTER(ct.c_int)]
    L.en265_push_image.argtypes = [ct.c_void_p, ct.c_void_p]
    L.en265_push_eof.argtypes = [ct.c_void_p]
    L.en265_encode.argtypes = [ct.c_void_p]
    L.en265_get_packet.restype = ct.POINTER(_Packet)
    L.en265_get_packet.argtypes = [ct.c_void_p, ct.c_int]
    L.en265_free_packet.argtypes = [ct.c_void_p, ct.c_void_p]
    L.en265_number_of_queued_packets.argtypes = [ct.c_void_p]
    return L


class Encoder:
    """One 8-bit 4:2:0 encoder: `params` (en265 names: bools, ints and
    named choices) are set before the encoder starts."""

    def __init__(self, L: ct.CDLL, params: dict):
        self._L = L
        self._ctx = L.en265_new_encoder()
        if not self._ctx:
            raise RuntimeError("en265_new_encoder failed")
        for name, value in params.items():
            key = name.encode()
            if isinstance(value, bool):
                err = L.en265_set_parameter_bool(self._ctx, key, int(value))
            elif isinstance(value, int):
                err = L.en265_set_parameter_int(self._ctx, key, value)
            else:
                err = L.en265_set_parameter_choice(self._ctx, key,
                                                   str(value).encode())
            if err != 0:
                raise ValueError(f"encoder parameter {name!r}={value!r} "
                                 f"rejected ({err})")
        L.en265_start_encoder(self._ctx, 0)

    def encode(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
               pts: int) -> bytes:
        """Push one picture (uint8 planes); returns the bytes it released."""
        L = self._L
        h, w = y.shape
        img = L.en265_allocate_image(self._ctx, w, h, 1, pts, None)
        if not img:
            raise RuntimeError("en265_allocate_image failed")
        for cidx, plane in ((0, y), (1, cb), (2, cr)):
            plane = np.ascontiguousarray(plane, np.uint8)
            stride = ct.c_int()
            ptr = L.en265_get_image_plane(img, cidx, ct.byref(stride))
            ph, pw = plane.shape
            dst = np.ctypeslib.as_array(
                ct.cast(ptr, ct.POINTER(ct.c_uint8)),
                shape=(ph * stride.value,)).reshape(ph, stride.value)
            dst[:, :pw] = plane
        L.en265_push_image(self._ctx, img)
        L.en265_encode(self._ctx)
        return self._drain()

    def finish(self) -> bytes:
        self._L.en265_push_eof(self._ctx)
        self._L.en265_encode(self._ctx)
        return self._drain()

    def _drain(self) -> bytes:
        L, out = self._L, []
        while L.en265_number_of_queued_packets(self._ctx) > 0:
            pkt = L.en265_get_packet(self._ctx, 0)
            if not pkt:
                break
            p = pkt.contents
            out.append(ct.string_at(p.data, p.length))
            L.en265_free_packet(self._ctx, pkt)
        return b"".join(out)

    def close(self):
        if self._ctx:
            self._L.en265_free_encoder(self._ctx)
            self._ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
