"""Multi-device decoding: port of ``libde265_tpu/parallel/``.

- tiles.py: a mesh is an ordered list of torch devices (``Mesh``,
  ``make_mesh``); the deblocking filter row-sharded for the vertical pass
  and column-sharded for the horizontal one (``sharded_filter_pipeline``);
  TU batches split data-parallel (``shard_residual_batch``).
- gop_parallel.py: IRAP-delimited segments parsed concurrently and
  decoded one FusedDecoder per device (``GopParallelDecoder``).
- sharded_decode.py: one tile of a picture per mesh entry, with the halo
  exchange for filters across tiles (``ShardedTileDecoder``).

One process drives every device; entries may repeat (k shards on one card
with ``["cuda:0"] * k``, or on the host with ``["cpu"] * k``).
"""

from .gop_parallel import GopParallelDecoder, split_segments  # noqa: F401
from .sharded_decode import (ShardedTileDecoder, tile_columns,  # noqa: F401
                             tile_grid)
from .tiles import (Mesh, make_mesh, shard_residual_batch,  # noqa: F401
                    sharded_filter_pipeline)
