"""High-level decoder wrapper: push-data / decode / pull-pictures, plus
FrameProgram export as numpy record arrays (the device-feed tensors).

A copy of ``libde265_tpu/decoder.py`` (ctypes and numpy only), kept here so
that the port never imports the JAX package.  Counterpart of the reference
libde265's dec265 usage of the C API (``dec265/dec265.cc``), with the added
tensor surface the device pipeline consumes.
"""
from __future__ import annotations

import ctypes as ct
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from ._native import ProgramView, lib

# numpy record dtypes mirroring the native SoA layouts (program.h)
OP_DTYPE = np.dtype({"names": ["kind", "idx"],
                     "formats": [np.uint8, np.uint32],
                     "offsets": [0, 4], "itemsize": 8})
TU_DTYPE = np.dtype({
    "names": ["x", "y", "log2_size", "cidx", "qp", "flags", "coeff_start",
              "ncoeff", "cross_comp_scale"],
    "formats": [np.uint16, np.uint16, np.uint8, np.uint8, np.int8, np.uint8,
                np.uint32, np.uint16, np.int8],
    "offsets": [0, 2, 4, 5, 6, 7, 8, 12, 14], "itemsize": 16})
PU_DTYPE = np.dtype({
    "names": ["x", "y", "w", "h", "mv0x", "mv0y", "mv1x", "mv1y", "ref_idx0",
              "ref_idx1", "pred_flags", "slice", "ref_dpb0", "ref_dpb1"],
    "formats": [np.uint16, np.uint16, np.uint16, np.uint16, np.int16, np.int16,
                np.int16, np.int16, np.int8, np.int8, np.uint8, np.uint16,
                np.int8, np.int8],
    "offsets": [0, 2, 4, 6, 8, 10, 12, 14, 16, 17, 18, 20, 22, 23],
    "itemsize": 24})
INTRA_DTYPE = np.dtype({
    "names": ["x", "y", "log2_size", "cidx", "mode"],
    "formats": [np.uint16, np.uint16, np.uint8, np.uint8, np.uint8],
    "offsets": [0, 2, 4, 5, 6], "itemsize": 8})
SAO_DTYPE = np.dtype({
    "names": ["type_idx", "eo_class", "band_pos", "offset"],
    "formats": [(np.uint8, (3,)), (np.uint8, (3,)), (np.uint8, (3,)),
                (np.int16, (3, 4))],
    "offsets": [0, 3, 6, 10], "itemsize": 34})

PCM_DTYPE = np.dtype({
    "names": ["x", "y", "log2_size", "data_start"],
    "formats": [np.uint16, np.uint16, np.uint8, np.uint32],
    "offsets": [0, 2, 4, 8], "itemsize": 12})

OP_INTRA, OP_RESIDUAL, OP_INTER, OP_PCM = 0, 1, 2, 3

# TuRec flags
TU_TRANSFORM_SKIP = 1
TU_TQ_BYPASS = 2
TU_USE_DST = 4
TU_RDPCM = 8
TU_RDPCM_VERTICAL = 16
TU_INTRA = 32


def _np_from(ptr, n, dtype, stride=None):
    if n == 0 or not ptr:
        return np.zeros(0, dtype=dtype)
    size = (stride or dtype.itemsize) * n
    buf = (ct.c_uint8 * size).from_address(ptr)
    return np.frombuffer(buf, dtype=dtype, count=n).copy()


@dataclass
class Picture:
    """A decoded picture (conformance-cropped views)."""
    poc: int
    planes: list  # numpy arrays [h, w]
    pts: int = 0

    @property
    def y(self):
        return self.planes[0]


@dataclass
class FrameProgramData:
    """Per-picture reconstruction program as host tensors."""
    poc: int
    width: int
    height: int
    chroma_width: int
    chroma_height: int
    bit_depth: tuple
    ops: np.ndarray
    tus: np.ndarray
    pus: np.ndarray
    intras: np.ndarray
    coeff_val: np.ndarray
    coeff_pos: np.ndarray
    ref_pocs: list
    ref_planes: list  # list of [Y, Cb, Cr] numpy copies
    # final (scalar-oracle) planes for validation
    planes: list = field(default_factory=list)
    # per-4x4 metadata
    qp_y: np.ndarray = None
    nonzero_coeff: np.ndarray = None
    deblock_flags: np.ndarray = None
    cu_info: np.ndarray = None
    sao: np.ndarray = None
    ctb_size: int = 64
    ctb_w: int = 0
    ctb_h: int = 0
    slice_idx: np.ndarray = None      # per CTB
    slice_records: np.ndarray = None  # [n_slices, 208] int32 (program.h)
    # expanded scaling factors when scaling lists are active:
    # {log2_size: uint8 [6, s, s]} (6 matrices per size), else None
    scaling_factors: dict = None
    slice_addr: np.ndarray = None   # per CTB SliceAddrRs [ctb_h, ctb_w]
    tile_id: np.ndarray = None      # per CTB tile id [ctb_h, ctb_w]
    across_tiles: bool = True
    # PCM blocks: records + raw samples (Y,Cb,Cr per block, sps depth)
    pcms: np.ndarray = None
    pcm_data: np.ndarray = None
    pcm_bit_depth: tuple = (8, 8)
    pcm_loop_filter_disable: bool = False
    # per-4x4 covering-PU index (-1 = no inter PU), painted natively at
    # parse time (program.h Snapshot::pu_idx)
    pu_idx: np.ndarray = None
    # native device intra plan (intraplan.cc): step/slot scheduling, border
    # gather plans, smoothing flags, residual-bin rows
    ip: dict = None
    # live native source (Decoder wrapper, program index) while the program
    # is retained — lets the fused decoder pack the device feed in C++
    # (feedpack.cc) instead of numpy
    src: tuple = None


class Decoder:
    """Push-data / decode / pull-picture HEVC decoder."""

    def __init__(self, check_hash: bool = False, keep_programs: bool = False,
                 disable_deblocking: bool = False, disable_sao: bool = False,
                 parse_only: bool = False, threads: int = 0):
        self._lib = lib()
        self._ctx = self._lib.de265_new_decoder()
        if check_hash:
            self._lib.de265_set_parameter_bool(self._ctx, 0, 1)
        if disable_deblocking:
            self._lib.de265_set_parameter_bool(self._ctx, 7, 1)
        if disable_sao:
            self._lib.de265_set_parameter_bool(self._ctx, 8, 1)
        if keep_programs:
            self._lib.tde265_set_keep_programs(self._ctx, 1)
        if parse_only:
            # host does syntax/CABAC only; pixels are reconstructed by an
            # external backend
            self._lib.tde265_set_parse_only(self._ctx, 1)
        if threads:
            # with keep_programs/parse_only set above, this enables the
            # parallel WPP-row / tile substream parse without starting the
            # host pixel pipeline worker
            self._lib.de265_start_worker_threads(self._ctx, threads)

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.de265_free_decoder(self._ctx)
            self._ctx = None

    def get_warnings(self):
        """Drain the decoder warning queue (de265_get_warning)."""
        out = []
        while True:
            w = self._lib.de265_get_warning(self._ctx)
            if not w:
                return out
            out.append(int(w))

    def push(self, data: bytes, pts: int = 0):
        buf = ct.create_string_buffer(data, len(data))
        self._lib.de265_push_data(self._ctx, buf, len(data), pts, None)

    def flush(self):
        self._lib.de265_flush_data(self._ctx)

    def _read_picture(self, img) -> Picture:
        L = self._lib
        planes = []
        n_chan = 1 if L.de265_get_chroma_format(img) == 0 else 3
        for c in range(n_chan):
            stride = ct.c_int()
            ptr = L.de265_get_image_plane(img, c, ct.byref(stride))
            w = L.de265_get_image_width(img, c)
            h = L.de265_get_image_height(img, c)
            bpp = 2 if L.de265_get_bits_per_pixel(img, c) > 8 else 1
            dt = np.uint16 if bpp == 2 else np.uint8
            buf = (ct.c_uint8 * (stride.value * h)).from_address(ptr)
            arr = np.frombuffer(buf, dtype=dt).reshape(h, stride.value // bpp)
            planes.append(arr[:, :w].copy())
        # POC isn't in public API; use PTS slot 0 default
        return Picture(poc=0, planes=planes,
                       pts=L.de265_get_image_PTS(img))

    def decode_all(self, data: bytes) -> Iterator[Picture]:
        """Decode a whole Annex-B stream, yielding pictures in output order."""
        self.push(data)
        self.flush()
        more = ct.c_int(1)
        while more.value:
            more.value = 0
            self._lib.de265_decode(self._ctx, ct.byref(more))
            while True:
                img = self._lib.de265_peek_next_picture(self._ctx)
                if not img:
                    break
                yield self._read_picture(img)
                self._lib.de265_release_next_picture(self._ctx)

    # ---- FrameProgram export ----

    def num_programs(self) -> int:
        return self._lib.tde265_num_programs(self._ctx)

    def get_program(self, idx: int) -> FrameProgramData:
        view = ProgramView()
        rc = self._lib.tde265_get_program(self._ctx, idx, ct.byref(view))
        if rc != 0:
            raise IndexError(idx)

        def plane_copy(ptr_arr, c, w, h, stride, bpp):
            if not ptr_arr[c]:
                return None
            dt = np.uint16 if bpp == 2 else np.uint8
            buf = (ct.c_uint8 * (stride * h * bpp)).from_address(ptr_arr[c])
            return np.frombuffer(buf, dtype=dt).reshape(h, stride)[:, :w].copy()

        ref_planes = []
        for r in range(view.n_refs):
            refs = [
                plane_copy(view.ref_plane[r], 0, view.width, view.height,
                           view.stride[0], view.bytes_pp),
                plane_copy(view.ref_plane[r], 1, view.chroma_width,
                           view.chroma_height, view.stride[1], view.bytes_pp),
                plane_copy(view.ref_plane[r], 2, view.chroma_width,
                           view.chroma_height, view.stride[2], view.bytes_pp),
            ]
            ref_planes.append(refs)

        planes = [
            plane_copy(view.plane, 0, view.width, view.height, view.stride[0],
                       view.bytes_pp),
            plane_copy(view.plane, 1, view.chroma_width, view.chroma_height,
                       view.stride[1], view.bytes_pp),
            plane_copy(view.plane, 2, view.chroma_width, view.chroma_height,
                       view.stride[2], view.bytes_pp),
        ]

        pbn = view.pb_w * view.pb_h
        return FrameProgramData(
            poc=view.poc,
            width=view.width,
            height=view.height,
            chroma_width=view.chroma_width,
            chroma_height=view.chroma_height,
            bit_depth=tuple(view.bit_depth),
            ops=_np_from(view.op_raw, view.n_ops, OP_DTYPE, view.op_stride),
            tus=_np_from(view.tu_raw, view.n_tus, TU_DTYPE, view.tu_stride),
            pus=_np_from(view.pu_raw, view.n_pus, PU_DTYPE, view.pu_stride),
            intras=_np_from(view.intra_raw, view.n_intras, INTRA_DTYPE,
                            view.intra_stride),
            coeff_val=_np_from(view.coeff_val, view.n_coeffs, np.dtype(np.int16)),
            coeff_pos=_np_from(view.coeff_pos, view.n_coeffs, np.dtype(np.uint16)),
            ref_pocs=[view.ref_poc[r] for r in range(view.n_refs)],
            ref_planes=ref_planes,
            planes=planes,
            qp_y=_np_from(view.qp_y, pbn, np.dtype(np.int8)).reshape(view.pb_h, view.pb_w),
            nonzero_coeff=_np_from(view.nonzero_coeff, pbn, np.dtype(np.uint8)).reshape(view.pb_h, view.pb_w),
            deblock_flags=_np_from(view.deblock_flags, pbn, np.dtype(np.uint8)).reshape(view.pb_h, view.pb_w),
            cu_info=_np_from(view.cu_info, pbn, np.dtype(np.uint8)).reshape(view.pb_h, view.pb_w),
            sao=_np_from(view.sao_raw, view.ctb_w * view.ctb_h,
                         SAO_DTYPE, view.sao_stride),
            ctb_w=view.ctb_w,
            ctb_h=view.ctb_h,
            slice_idx=_np_from(view.slice_idx, view.ctb_w * view.ctb_h,
                               np.dtype(np.uint16)).reshape(view.ctb_h,
                                                            view.ctb_w),
            slice_records=_np_from(view.slice_records, view.n_slices * 208,
                                   np.dtype(np.int32)).reshape(view.n_slices,
                                                               208),
            scaling_factors=self._read_scaling(view),
            slice_addr=_np_from(view.slice_addr, view.ctb_w * view.ctb_h,
                                np.dtype(np.int32)).reshape(view.ctb_h,
                                                            view.ctb_w),
            tile_id=_np_from(view.tile_id, view.ctb_w * view.ctb_h,
                             np.dtype(np.int32)).reshape(view.ctb_h,
                                                         view.ctb_w),
            across_tiles=bool(view.across_tiles),
            ctb_size=int(view.ctb_size),
            pcms=_np_from(view.pcm_raw, view.n_pcms, PCM_DTYPE,
                          view.pcm_stride),
            pcm_data=_np_from(view.pcm_data, view.n_pcm_data,
                              np.dtype(np.uint16)),
            pcm_bit_depth=tuple(view.pcm_bit_depth),
            pcm_loop_filter_disable=bool(view.pcm_loop_filter_disable),
            pu_idx=_np_from(view.pu_idx, pbn, np.dtype(np.int32)).reshape(
                view.pb_h, view.pb_w),
            ip={
                "step": _np_from(view.ip_step, view.n_intras,
                                 np.dtype(np.int32)),
                "slot": _np_from(view.ip_slot, view.n_intras,
                                 np.dtype(np.int32)),
                "rrow": _np_from(view.ip_rrow, view.n_intras,
                                 np.dtype(np.int32)),
                "flags": _np_from(view.ip_flags, view.n_intras,
                                  np.dtype(np.uint8)),
                "edge": _np_from(view.ip_edge, view.n_intras,
                                 np.dtype(np.uint8)),
                "bpos": _np_from(view.ip_border_pos, view.ip_n_border,
                                 np.dtype(np.int32)),
                "bsub": _np_from(view.ip_border_sub, view.ip_n_border,
                                 np.dtype(np.int32)),
                "boff": _np_from(view.ip_border_off, view.n_intras + 1,
                                 np.dtype(np.uint32)),
            } if view.n_intras else None,
            src=(self, idx),
        )

    @staticmethod
    def _read_scaling(view):
        if not view.scaling_enabled or not view.scaling_factors:
            return None
        total = 6 * (16 + 64 + 256 + 1024)
        raw = _np_from(view.scaling_factors, total, np.dtype(np.uint8))
        out, off = {}, 0
        for lg in (2, 3, 4, 5):
            s = 1 << lg
            n = 6 * s * s
            out[lg] = raw[off:off + n].reshape(6, s, s).copy()
            off += n
        return out

    def programs(self):
        return [self.get_program(i) for i in range(self.num_programs())]
