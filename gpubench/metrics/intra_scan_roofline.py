"""intra_scan_roofline: the persistent intra scan's share of its roofline
(%): the least time of the intra prediction that the profiled pictures
need, over the device time of intra_scan_kernel (csrc/intra.cu) in the
profiled stretch.

The work is counted from the pictures' FrameProgram, never from the
tensors the program passes.  For each intra block of size N: its border
read once (4N + 1 samples), its residual read once where its transform
unit has coefficients (N x N, two bytes a value: a residual needs one bit
more than a sample), its prediction written once (N x N), samples at one
byte (8-bit).  Operations a predicted sample: planar 8 (four products,
four sums), DC 1, horizontal and vertical 0, other angles 5 (two
products, two sums, a shift); a residual adds 2 (the sum and the clip);
the border's smoothing 4 a border sample for blocks of 8 and more.
"""
import numpy as np

from gbench import peaks

KERNELS = ("intra_scan_kernel",)


def _pred_ops(mode):
    """Operations a predicted sample by intra mode (numpy array)."""
    return np.where(mode == 0, 8, np.where(
        mode == 1, 1, np.where((mode == 10) | (mode == 26), 0, 5)))


def _keys(rec):
    return ((rec["x"].astype(np.int64) << 24) |
            (rec["y"].astype(np.int64) << 8) |
            (rec["log2_size"].astype(np.int64) << 2) |
            rec["cidx"].astype(np.int64))


def intra_work(intras, tus, bytes_per_sample: int = 1):
    """(bytes, operations) of the intra prediction of intra block records
    (x, y, log2_size, cidx, mode) given the TU records (x, y, log2_size,
    cidx, ncoeff) of the same picture."""
    n = np.left_shift(1, intras["log2_size"].astype(np.int64))
    coded = np.isin(_keys(intras),
                    _keys(tus)[np.asarray(tus["ncoeff"]) > 0])
    border = 4 * n + 1
    nbytes = (border + n * n) * bytes_per_sample + coded * n * n * 2
    ops = n * n * _pred_ops(intras["mode"].astype(np.int64)) + \
        (n >= 8) * 4 * border + coded * 2 * n * n
    return int(nbytes.sum()), int(ops.sum())


def read(run):
    t = run.trace_data
    if t is None:
        return None
    dev = t.device_seconds(KERNELS)
    if dev <= 0:
        return None
    nbytes = ops = 0
    for prog in run.traced_programs:
        b, o = intra_work(prog.intras, prog.tus,
                          (int(prog.bit_depth[0]) + 7) // 8)
        nbytes, ops = nbytes + b, ops + o
    if not nbytes:
        return None
    return 100.0 * peaks.least_seconds(nbytes, ops) / dev
