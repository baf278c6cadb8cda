"""Tile-parallel execution of the pixel pipeline over a list of devices.

Port of ``libde265_tpu/parallel/tiles.py``.  A mesh is an ordered list of
``torch.device`` entries with an axis name (``Mesh``); one process drives
every entry.  The two deblocking passes have orthogonal dependence
directions:

- vertical-edge pass: every image row is independent  -> shard rows
- horizontal-edge pass: every image column is independent -> shard columns

so a picture is filtered as: row shards through the V pass, each on its
device; gathered and cut into column shards for the H pass; gathered back.
Shards are cut at multiples of 4 rows (columns), so that each 4-line
deblocking segment, with its row of edge parameters, stays whole.  The
same entry may repeat: ``devices=["cuda:0"] * k`` runs k shards on one
card, ``["cpu"] * k`` runs them on the host.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch

from ..ops.deblock_cuda import luma_pass


class Mesh:
    """An ordered list of torch devices and the names of its axes (one
    axis).  Entries may repeat."""

    def __init__(self, devices, axis_names=("tiles",)):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"


def cuda_devices():
    """Every CUDA device of this process, in index order."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def on_device(dev: torch.device):
    """The context that makes `dev` the current CUDA device (the kernels
    launch on the current device), or nothing for the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def make_mesh(n_devices: int | None = None, axis: str = "tiles",
              devices=None) -> Mesh:
    """A 1-D mesh of the first `n_devices` of `devices` (all of them if
    None).  With devices=None the CUDA devices are taken; there is no
    fallback to the CPU, so fewer than `n_devices` cards raise
    RuntimeError.  k shards on one card: devices=["cuda:0"] * k."""
    devs = cuda_devices() if devices is None else list(devices)
    n = n_devices or len(devs)
    if n == 0 or len(devs) < n:
        raise RuntimeError(
            f"need {n or 1} devices, have {len(devs)}"
            + (" CUDA devices; pass devices= (e.g. ['cuda:0'] * k or "
               "['cpu'] * k)" if devices is None else ""))
    return Mesh(devs[:n], (axis,))


def split_sizes(n: int, k: int, unit: int = 4):
    """k shard lengths summing to n, each a multiple of `unit` but the
    last (uneven shards allowed; trailing shards may be empty)."""
    units = -(-n // unit)
    base, extra = divmod(units, k)
    sizes = [(base + (i < extra)) * unit for i in range(k)]
    sizes[-1] -= sum(sizes) - n
    for i in range(k - 1, 0, -1):    # a short tail borrows from before it
        if sizes[i] < 0:
            sizes[i - 1] += sizes[i]
            sizes[i] = 0
    return sizes


def shard_residual_batch(mesh: Mesh, levels, fact, tskip, use_dst):
    """A TU residual batch split data-parallel over the mesh: returns four
    lists (levels, fact, tskip, use_dst), each of mesh.size chunks of the
    array along dim 0 (torch.tensor_split: the first chunks one row longer
    where the rows do not divide), chunk i moved to mesh.devices[i].
    There is no global sharded array: a caller runs chunk i on device i."""
    k = mesh.size
    return tuple(
        [c.to(d) for c, d in zip(torch.tensor_split(a, k), mesh.devices)]
        for a in (levels, fact, tskip, use_dst))


def sharded_filter_pipeline(mesh: Mesh):
    """Returns fn(img, v params..., h params...) -> filtered image: the V
    then H luma deblocking passes of ops.deblock_cuda.luma_pass (kernel B8
    on a CUDA tensor, its plain version on a CPU tensor), row-sharded for
    V and column-sharded for H over the mesh's devices.

    The signature matches luma_pass twice: img is [H, W+8] int32 with the
    picture at columns [4, W+4); v params [H/4, Ev]; h params
    [(W+8)/4, Eh] for the pass over img's transpose.  The result equals
    luma_pass(luma_pass(img, v...).T, h...).T, on img's device."""
    devs = mesh.devices

    def fn(img, bs_v, beta_v, tc_v, nop_v, noq_v, bs_h, beta_h, tc_h, nop_h,
           noq_h):
        home = img.device
        v_prm = (bs_v, beta_v, tc_v, nop_v, noq_v)
        h_prm = (bs_h, beta_h, tc_h, nop_h, noq_h)

        def passes(planes, prm):
            """luma_pass over each (shard, its device) pair; prm rows are
            cut at a quarter of the planes' rows (every shard but the last
            has a multiple of 4)."""
            out, r4 = [], 0
            for plane, dev in zip(planes, devs):
                n4 = -(-plane.shape[0] // 4)
                if plane.shape[0]:
                    args = [p[r4:r4 + n4].contiguous().to(dev) for p in prm]
                    out.append(luma_pass(plane.to(dev), *args, bit_depth=8)
                               .to(home))
                r4 += n4
            return torch.cat(out)

        rows = split_sizes(img.shape[0], len(devs))
        v = passes(torch.split(img, rows), v_prm)
        cols = split_sizes(v.shape[1], len(devs))
        h = passes([c.T.contiguous() for c in torch.split(v, cols, dim=1)],
                   h_prm)
        return h.T

    return fn
