"""The per-op device decoder, on the CUDA card: the PyTorch port of
``libde265_tpu/tpu_decode.py`` (``DeviceDecoder``).

The host parses (the native front end's FramePrograms); every stage with
pixel shape runs as its own batch of operations on `device`, the CUDA card
unless the caller asks for the CPU, with the decoded pictures kept there as
the references of later ones.  The stages are those of the per-op picture
pipeline (``pipeline.reconstruct`` with the intra wavefront): size-binned
residuals at each TU's channel depth, batched MC from the references
stacked on the device, PCM and the inter residuals, the intra wavefronts
(ops.intra_wave), deblocking through frame_helpers.deblock_planes (kernel
B8 once, B9 once) and SAO through ops.sao_cuda.sao_plane_fused (kernel
B10 once per plane), with the JAX module's gates (no deblocking when every
slice disables it, no SAO when no slice enables it).  This module adds the
decoder's DPB: the references of a picture are its own earlier pictures.

The JAX module's faults are not carried over (ROADMAP C): the chroma
deblocking edge count (C12, the C1 fault), gray planes for a reference it
never decoded (C13: the port reads the planes the parser attached, else
raises RuntimeError naming the POC), more than 8 references (C14) and the
luma depth for every residual bin (C15).
"""
from __future__ import annotations

import torch

from . import pipeline
from .decoder import TU_RDPCM, FrameProgramData
from .fused_decode import _attached

MAX_REFS = 8  # references a picture of the JAX module's own path may read


def _jax_routes(prog: FrameProgramData) -> bool:
    """Whether the JAX module leaves prog to its pipeline (cross-component
    prediction, RDPCM) or fails on it (more than MAX_REFS references)."""
    tus = prog.tus
    return len(prog.ref_pocs) > MAX_REFS or bool(len(tus) and (
        (tus["cross_comp_scale"] != 0).any() or
        ((tus["flags"] & TU_RDPCM) != 0).any()))


class DeviceDecoder:
    """Reconstructs FramePrograms with a DPB on `device` (the CUDA card
    unless the caller asks for the CPU).

    Usage:
        dd = DeviceDecoder()
        planes = dd.decode(prog)          # int32 device tensors, by POC
        np_planes = [p.cpu().numpy() for p in planes]   # only when needed

    run_deblock / run_sao switch the loop filters off.  pipeline_pictures:
    the pictures that the JAX module sends to its pipeline (CCP, RDPCM) or
    cannot decode (more than MAX_REFS references); here every picture takes
    the same path.
    """

    def __init__(self, device="cuda", run_deblock=True, run_sao=True):
        self.device = torch.device(device)
        self.run_deblock = run_deblock
        self.run_sao = run_sao
        self.dpb = {}     # poc -> (y, cb, cr) device tensors
        self._order = []  # insertion order for eviction
        self.pipeline_pictures = 0

    def _ref_planes(self, prog):
        """[Y, Cb, Cr] of every reference of prog: the decoder's own
        picture, else the planes the parser attached (a seek), else
        RuntimeError naming the POC."""
        refs = []
        for i, poc in enumerate(prog.ref_pocs):
            planes = self.dpb.get(poc) or _attached(prog, i, self.device)
            if planes is None:
                raise RuntimeError(
                    f"picture POC {prog.poc}: reference POC {poc} is neither "
                    "in the decoder's DPB nor attached to the program")
            refs.append(planes)
        return refs

    def decode(self, prog: FrameProgramData):
        """The picture's planes, one int32 tensor each on `device` (one
        plane for 4:0:0), stored in the DPB under its POC."""
        planes = pipeline.reconstruct(prog, self.run_deblock, self.run_sao,
                                      device_intra=True, device=self.device,
                                      ref_planes=self._ref_planes(prog))
        self.pipeline_pictures += _jax_routes(prog)
        out = tuple(p.contiguous()
                    for p in planes[:3 if prog.chroma_width else 1])
        self._store(prog.poc, out)
        return out

    def _store(self, poc, planes):
        self.dpb[poc] = planes
        self._order.append(poc)
        while len(self._order) > 2 * MAX_REFS:
            old = self._order.pop(0)
            if old in self.dpb and old not in self._order:
                del self.dpb[old]
