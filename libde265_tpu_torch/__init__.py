"""libde265_tpu_torch: the PyTorch + CUDA port of libde265_tpu's device
decode.

It imports neither JAX nor ``libde265_tpu``: the ctypes bindings of the
native parser and encoder (``decoder``, ``encoder``, ``_native``,
``profiles``) and the angle tables of ``ops.intra`` are copies of the JAX
package's JAX-free modules.  The whole-picture program is PyTorch; its
feed expansion, PU map, motion compensation, coefficient densify, residual
stripes, intra scan (one persistent kernel a picture, and its records),
deblocking and SAO stages are hand-written CUDA kernels for Hopper
(``csrc/``), built with nvcc at first use.  The decoders run on the CUDA
card unless given ``device="cpu"``; on CPU tensors every kernel runs its
plain PyTorch version.  ``parallel``
decodes over several devices (segments or tiles), the CUDA cards unless
given a list of devices.

Float32 matrix products would not be exact for the transform sums, so the
port runs them in float64 and keeps TF32 off: the two flags below are set
when the package is imported.
"""

import torch

from .decoder import Decoder, FrameProgramData, Picture  # noqa: F401
from .encoder import Encoder  # noqa: F401

from .fused_decode import FusedDecoder  # noqa: F401
from .stream import PipelinedDecoder  # noqa: F401
from .parallel import (GopParallelDecoder, Mesh,  # noqa: F401
                       ShardedTileDecoder, make_mesh, shard_residual_batch,
                       sharded_filter_pipeline, split_segments, tile_columns,
                       tile_grid)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["Decoder", "Encoder", "FrameProgramData", "FusedDecoder",
           "GopParallelDecoder", "Mesh", "Picture", "PipelinedDecoder",
           "ShardedTileDecoder", "make_mesh", "shard_residual_batch",
           "sharded_filter_pipeline", "split_segments", "tile_columns",
           "tile_grid"]
