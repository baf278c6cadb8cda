"""mc_roofline: the MC stage's share of its roofline (%): the least time
of the motion compensation that the profiled pictures need, over the
device time of the MC stage's kernels in the profiled stretch.

The work is counted from the pictures' FrameProgram (the parse of the
stream), never from the tensors the program passes, so a kernel that
changes its layout reads the same work.  For each inter PU and each
reference list it predicts from: the reference window it reads (luma
w x h, widened by 7 in each direction with a fractional motion vector
component, the 8-tap filter; each chroma plane w/2 x h/2, widened by 3,
the 4-tap filter) and the predicted samples it writes once (w x h + 2 x
w/2 x h/2), at one byte a sample (8-bit).  Operations: a multiply and an
add a tap of each separable pass (the horizontal pass over the widened
rows where both components are fractional), then the rounding, shift and
clip of each written sample (3; 4 for the average of two lists).
"""
import numpy as np

from gbench import peaks

KERNELS = ("mc_kernel", "paint_kernel")   # csrc/mc.cu: B3 and B2


def pu_work(pus, bytes_per_sample: int = 1):
    """(bytes, operations) of the motion compensation of PU records
    (fields w, h, pred_flags, mv0x, mv0y, mv1x, mv1y; 4:2:0)."""
    w = pus["w"].astype(np.int64)
    h = pus["h"].astype(np.int64)
    flags = pus["pred_flags"].astype(np.int64)
    cw, ch = w // 2, h // 2
    used = [(flags & 1) > 0, (flags & 2) > 0]
    n_lists = used[0].astype(np.int64) + used[1]
    samples = (w * h + 2 * cw * ch) * (n_lists > 0)
    nbytes = samples * bytes_per_sample
    ops = samples * np.where(n_lists == 2, 4, 3)
    for k, on in enumerate(used):
        mx = pus[f"mv{k}x"].astype(np.int64)
        my = pus[f"mv{k}y"].astype(np.int64)
        fx, fy = (mx & 3) > 0, (my & 3) > 0
        cfx, cfy = (mx & 7) > 0, (my & 7) > 0
        lb = (w + 7 * fx) * (h + 7 * fy) + \
            2 * (cw + 3 * cfx) * (ch + 3 * cfy)
        lo = 16 * w * (h + 7 * fy) * fx + 16 * w * h * fy + \
            16 * cw * (ch + 3 * cfy) * cfx + 16 * cw * ch * cfy
        nbytes = nbytes + on * lb * bytes_per_sample
        ops = ops + on * lo
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
        b, o = pu_work(prog.pus, (int(prog.bit_depth[0]) + 7) // 8)
        nbytes, ops = nbytes + b, ops + o
    if not nbytes:
        return None
    return 100.0 * peaks.least_seconds(nbytes, ops) / dev
