"""Python encoder bindings over the en265 C API.

A copy of ``libde265_tpu/encoder.py`` (ctypes and numpy only), kept here so
that the port never imports the JAX package.  Capability counterpart of the
reference libde265's en265.h workflow (allocate image -> push -> encode ->
drain packets), exposed as a simple `Encoder` class producing Annex-B
bytes per pushed frame.
"""
from __future__ import annotations

import ctypes as ct
from typing import Iterator, Optional, Tuple

import numpy as np

from ._native import lib


class _En265Packet(ct.Structure):
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


def _bind(L: ct.CDLL) -> ct.CDLL:
    if getattr(L, "_en265_bound", False):
        return L
    L.en265_new_encoder.restype = ct.c_void_p
    L.en265_free_encoder.argtypes = [ct.c_void_p]
    L.en265_start_encoder.argtypes = [ct.c_void_p, ct.c_int]
    L.en265_set_parameter_int.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_int]
    L.en265_set_parameter_bool.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_int]
    L.en265_set_parameter_string.argtypes = [ct.c_void_p, ct.c_char_p,
                                             ct.c_char_p]
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
    L.en265_get_packet.restype = ct.POINTER(_En265Packet)
    L.en265_get_packet.argtypes = [ct.c_void_p, ct.c_int]
    L.en265_free_packet.argtypes = [ct.c_void_p, ct.c_void_p]
    L.en265_number_of_queued_packets.argtypes = [ct.c_void_p]
    L._en265_bound = True
    return L


_DE265_CHROMA_420 = 1
_DE265_CHROMA_422 = 2
_DE265_CHROMA_444 = 3


class Encoder:
    """Intra HEVC encoder producing Annex-B NAL streams.

    >>> enc = Encoder(qp=30)
    >>> bits = enc.encode(y, cb, cr)       # one I-frame as bytes
    >>> stream = enc.finish()              # drain remaining packets
    """

    def __init__(self, qp: int = 30, ctb_size: int = 64,
                 min_cb_size: int = 8, fps: int = 25, bit_depth: int = 8,
                 chroma_format: str = "420", level_idc: int = 0):
        """level_idc: signalled general_level_idc; 0 = automatic (the
        Annex-A minimum level for the picture size and frame rate, per
        profiles.min_level_for — the native encoder computes the
        same table)."""
        self._L = _bind(lib())
        self._ctx = self._L.en265_new_encoder()
        if not self._ctx:
            raise RuntimeError("en265_new_encoder failed")
        self.bit_depth = bit_depth
        self._level_idc = level_idc
        self._fps = fps
        self.chroma = {"mono": 0, "400": 0, "420": 1, "422": 2, "444": 3,
                       0: 0, 1: 1, 2: 2, 3: 3}[chroma_format]
        self.set_parameter("qp", qp)
        self.set_parameter("ctb-size", ctb_size)
        self.set_parameter("min-cb-size", min_cb_size)
        self.set_parameter("fps", fps)
        self.set_parameter("bit-depth", bit_depth)
        if level_idc:
            self.set_parameter("level-idc", level_idc)
        self._L.en265_start_encoder(self._ctx, 0)
        self._frames = 0

    def set_parameter(self, name: str, value) -> None:
        if isinstance(value, bool):
            err = self._L.en265_set_parameter_bool(
                self._ctx, name.encode(), int(value))
        elif isinstance(value, int):
            err = self._L.en265_set_parameter_int(
                self._ctx, name.encode(), value)
        else:
            # named-choice params (algo selectors, sop-structure) route
            # through the choice setter; everything else is a string param
            err = self._L.en265_set_parameter_choice(
                self._ctx, name.encode(), str(value).encode())
            if err != 0:
                err = self._L.en265_set_parameter_string(
                    self._ctx, name.encode(), str(value).encode())
        if err != 0:
            raise ValueError(f"parameter {name!r}={value!r} rejected ({err})")

    def encode(self, y: np.ndarray, cb: Optional[np.ndarray] = None,
               cr: Optional[np.ndarray] = None, pts: int = 0) -> bytes:
        """Encode one 4:2:0 frame (uint8, or uint16 for bit_depth > 8);
        returns its Annex-B bytes."""
        dtype = np.uint16 if self.bit_depth > 8 else np.uint8
        ctype = ct.c_uint16 if self.bit_depth > 8 else ct.c_uint8
        mid = 1 << (self.bit_depth - 1)
        y = np.ascontiguousarray(y, dtype=dtype)
        h, w = y.shape
        if self._frames == 0 and self._level_idc:
            from .profiles import min_level_for
            need = min_level_for(w, h, self._fps).idc
            if self._level_idc < need:
                import warnings
                warnings.warn(
                    f"level_idc {self._level_idc} is below the Annex-A "
                    f"minimum {need} for {w}x{h}@{self._fps}fps; decoders "
                    f"will flag the stream as non-conformant")
        sub_x = 1 if self.chroma == _DE265_CHROMA_444 else 2
        sub_y = 2 if self.chroma == _DE265_CHROMA_420 else 1
        if self.chroma == 0:
            cb = cr = np.zeros((0, 0), dtype)
        if cb is None:
            cb = np.full((h // sub_y, w // sub_x), mid, dtype)
        if cr is None:
            cr = np.full((h // sub_y, w // sub_x), mid, dtype)
        img = self._L.en265_allocate_image(self._ctx, w, h, self.chroma,
                                           pts, None)
        if not img:
            raise RuntimeError("en265_allocate_image failed (4:2:0 only)")
        chans = [(0, y)]
        if self.chroma != 0:
            chans += [(1, np.ascontiguousarray(cb, dtype)),
                      (2, np.ascontiguousarray(cr, dtype))]
        for cidx, plane in chans:
            stride = ct.c_int()
            ptr = self._L.en265_get_image_plane(img, cidx, ct.byref(stride))
            ph, pw = plane.shape
            dst = np.ctypeslib.as_array(
                ct.cast(ptr, ct.POINTER(ctype)),
                shape=(ph * stride.value,)).reshape(ph, stride.value)
            dst[:, :pw] = plane
        self._L.en265_push_image(self._ctx, img)
        self._L.en265_encode(self._ctx)
        self._frames += 1
        return b"".join(data for _, data in self._drain())

    def _drain(self) -> Iterator[Tuple[int, bytes]]:
        while self._L.en265_number_of_queued_packets(self._ctx) > 0:
            pkt = self._L.en265_get_packet(self._ctx, 0)
            if not pkt:
                break
            p = pkt.contents
            yield p.frame_number, bytes(
                bytearray(ct.cast(p.data,
                                  ct.POINTER(ct.c_uint8 * p.length)).contents))
            self._L.en265_free_packet(self._ctx, pkt)

    def finish(self) -> bytes:
        """Signal EOF and drain any remaining packets."""
        self._L.en265_push_eof(self._ctx)
        self._L.en265_encode(self._ctx)
        return b"".join(data for _, data in self._drain())

    def close(self) -> None:
        if self._ctx:
            self._L.en265_free_encoder(self._ctx)
            self._ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
