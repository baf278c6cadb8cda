"""The persistent intra scan (``csrc/intra.cu`` ``tde_intra_scan``) in its
design of one block barrier a step: the argument struct and the limits the
wrapper checks, and scans at the edges of what the kernel takes, bit-exact
(tolerance 0: integers).

On the CPU: ``intra_cuda.fill_scan_args`` (the kernel's arguments, filled
without a launch) against the records it is given; a scan whose 4x4 bins
are full (``chip_smoke.full_bin_intra``: 256 blocks in one luma step, a
step with no valid block) checked against the scheduler's invariant and
decoded by the port's plain scan against the JAX program's whole scan
(its padded-plane scan, the Pallas kernels in interpret mode), at 12
bits.  The `gpu`-marked tests hold the kernel against
``intra_scan_plain`` on the card, one launch a scan: synthetic scans with
all four size bins in shared steps and all three planes at 8, 10 and 12
bits, the full 4x4 bins, a build with the smallest CTA (one consumer warp
that runs every block of a step in turn), and the captured scans of the
4:4:4 CCP streams; and the chain probe that measures the scan's chain
bound.
"""
import ctypes as ct
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libde265_tpu import fused_decode as jfd

from libde265_tpu_torch import fused_decode as tfd
from libde265_tpu_torch.feed import WAVE_CAP, bin_depths
from libde265_tpu_torch.ops import _build, intra_cuda

from _torch_common import REPO, cuda  # noqa: F401
from test_torch_ccp_rdpcm import ccp_stream
from test_torch_intra_window import (_border_cells, _capture_scans, _on,
                                     _check_scan_kernel)

sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the synthetic schedules, as on the card)


def _bins(irec):
    return tuple(sorted({(("y", "cb", "cr")[c], lg)
                         for c, lg in irec[:, 8:10].tolist()}))


def test_scan_args_fill():
    """The ctypes struct has the C layout (ScanBin 48 bytes, ScanPlane 216,
    ScanArgs 672 on x86-64), and fill_scan_args puts every bin's records,
    K, depth and residual rows where the kernel reads them."""
    assert ct.sizeof(intra_cuda._ScanBin) == 48
    assert ct.sizeof(intra_cuda._ScanPlane) == 216
    assert ct.sizeof(intra_cuda.ScanArgs) == 672
    padded, bins, res, tables, nsteps, bds = chip_smoke.synthetic_scan_inputs(
        0, "cpu")
    a, work = intra_cuda.fill_scan_args(padded, bins, res, tables, nsteps,
                                        bds)
    assert work and a.n_planes == 3 and a.aw_words == 5
    assert not a.stamps
    for c in range(3):
        P = a.planes[c]
        assert (P.Hp, P.Wp) == tuple(padded[c].shape)
        assert P.plane == padded[c].data_ptr() and P.bit_depth == bds[c]
        assert P.nsteps == max(v["depth"] for v in bins[c].values())
        for lg in (2, 3, 4, 5):
            B = P.bins[lg - 2]
            v = bins[c].get(lg)
            if v is None:
                assert B.depth == 0
                continue
            assert (B.K, B.depth, B.n_res) == (WAVE_CAP[lg], v["depth"],
                                               res[lg].shape[0])
            assert (B.meta, B.rrow, B.aw, B.res) == (
                v["meta"].data_ptr(), v["rrow"].data_ptr(),
                v["aw"].data_ptr(), res[lg].data_ptr())


@pytest.mark.parametrize("lg", [2, 3, 4, 5])
def test_scan_args_reject_wide_bins(lg):
    """A bin wider than the kernel's slots for its size (MAX_SLOTS, the
    shared memory's) or whose K is not a multiple of 4 raises before any
    launch; the widest bins the kernel takes pass."""
    s = 1 << lg

    def args(K):
        meta = torch.zeros((2, K, 5), dtype=torch.int32)
        rrow = torch.full((2, K), -1, dtype=torch.int32)
        aw = torch.zeros((2, K, 5), dtype=torch.int32)
        bins = {0: {lg: {"meta": meta, "rrow": rrow, "aw": aw,
                         "depth": 2}}}
        return ([torch.zeros((64, 256), dtype=torch.int32)], bins,
                {lg: torch.zeros((1, s, s), dtype=torch.int32)},
                {lg: intra_cuda.mode_tables(s, torch.device("cpu"))},
                np.array([2]), [8])

    a, work = intra_cuda.fill_scan_args(*args(intra_cuda.MAX_SLOTS[lg]))
    assert work and a.planes[0].bins[lg - 2].K == WAVE_CAP[lg]
    for K in (intra_cuda.MAX_SLOTS[lg] + 4, intra_cuda.MAX_SLOTS[lg] - 2):
        with pytest.raises(ValueError, match="bad records"):
            intra_cuda.fill_scan_args(*args(K))


def test_full_bin_schedule_reads_only_earlier_steps():
    """chip_smoke.full_bin_intra keeps the scan's invariant (no available
    border sample outside the plane or in a block of the same or a later
    step), fills the 4x4 bin of luma step 0 (K valid blocks) and leaves
    step 1 without a valid block, in every plane."""
    planes, irec, nsteps, _ = chip_smoke.full_bin_intra(0)
    bins = intra_cuda.scatter_records(
        torch.from_numpy(irec), _bins(irec), 3,
        bin_depths(irec[:, 8], irec[:, 9], irec[:, 6]))
    for c, by_lg in bins.items():
        h, w = planes[c].shape
        v = by_lg[2]
        meta, aw = v["meta"].numpy(), v["aw"].numpy()
        valid = (meta[..., 4] & 8) != 0
        assert valid[0].any() and not valid[1].any() and valid[2].any()
        if c == 0:
            assert valid[0].sum() == WAVE_CAP[2]
        writer = np.full((h, w), -1)
        for i in range(3):
            for y, x in meta[i][valid[i], 2:4]:
                writer[y:y + 4, x:x + 4] = i
        for i in range(3):
            by, bx, av, inside = _border_cells(meta[i][valid[i]],
                                               aw[i][valid[i]], 4, h, w)
            assert not (av & ~inside).any()
            assert not (av & (writer[by, bx] >= i)).any()
        assert (writer >= 0).any()


def test_intra_scan_full_bin_matches_jax():
    """The full-bin scan at 12 bits: the port's scan (intra_scan, its
    plain version on the CPU) against the JAX program's whole scan,
    bit-exact, every plane changed."""
    bd = 12
    planes, irec, nsteps, res = chip_smoke.full_bin_intra(1, bit_depth=bd)
    bins = _bins(irec)
    st = {"bd": bd, "bdc": bd, "pallas_intra": True, "pallas_interp": True,
          "intra_bins": bins, "steps_cap": 3}
    jb = jfd._scatter_intra_bins(jnp.asarray(irec), bins, 3)
    want = jfd._intra_scan_all([jnp.asarray(p) for p in planes], jb,
                               {lg: jnp.asarray(r) for lg, r in res.items()},
                               st, jnp.asarray(nsteps))
    tb = intra_cuda.scatter_records(
        torch.from_numpy(irec), bins, 3,
        bin_depths(irec[:, 8], irec[:, 9], irec[:, 6]))
    got = tfd._intra_scan_all([torch.from_numpy(p) for p in planes], tb,
                              {lg: torch.from_numpy(r)
                               for lg, r in res.items()}, st, nsteps)
    for c, (g, w_) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_),
                                      err_msg=f"plane {c}")
        assert not np.array_equal(g.numpy(), planes[c])


# ---------------------------------------------------------------------------
# the kernel against its plain version (skip without a card)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_intra_scan_kernel_12bit(cuda, seed):
    """All four size bins in shared steps, three planes, 12-bit samples."""
    _check_scan_kernel(chip_smoke.synthetic_scan_inputs(seed, cuda,
                                                        bit_depth=12))


@pytest.mark.gpu
@pytest.mark.parametrize("bit_depth", [8, 10, 12])
def test_intra_scan_kernel_full_bin(cuda, bit_depth):
    """256 valid 4x4 blocks in one step and a step with no valid block."""
    _check_scan_kernel(chip_smoke.scan_inputs(
        chip_smoke.full_bin_intra(2, bit_depth=bit_depth), cuda, bit_depth))


@pytest.mark.gpu
def test_intra_scan_kernel_one_consumer_warp(cuda):
    """The decode's build has a CTA of 1024 threads; a build with 64
    (TDE_SCAN_THREADS: the producer warp and one consumer warp, which runs
    every block of a step in turn in the same border memory) on the
    all-sizes and the full-bin scans equals the plain version."""
    assert _build.lib().tde_scan_threads() == 1024
    lib = _build.variant(_build._CSRC / "intra.cu", ["TDE_SCAN_THREADS=64"])
    assert lib.tde_scan_threads() == 64
    for padded, *scan in (chip_smoke.synthetic_scan_inputs(0, cuda),
                          chip_smoke.scan_inputs(chip_smoke.full_bin_intra(3),
                                                 cuda)):
        got = [p.clone() for p in padded]
        a, work = intra_cuda.fill_scan_args(got, *scan)
        assert work
        rc = lib.tde_intra_scan(ct.addressof(a),
                                torch.cuda.current_stream().cuda_stream)
        _build.check_launch("tde_intra_scan (64 threads)", rc)
        want = intra_cuda.intra_scan_plain([p.clone() for p in padded],
                                           *scan)
        torch.cuda.synchronize()
        for c, (g, w_) in enumerate(zip(got, want)):
            assert torch.equal(g, w_), f"plane {c}"
        assert any(not torch.equal(g, p) for g, p in zip(got, padded))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["lossless", "lossy"])
def test_intra_scan_kernel_captured_ccp(cuda, native_build, monkeypatch,
                                        mode):
    """Every intra scan of a 4:4:4 CCP stream (three full-size planes):
    the kernel against its plain version and the CPU decode's scan."""
    scans = _capture_scans(monkeypatch, ccp_stream(mode))
    assert scans
    for scan in scans:
        got = _check_scan_kernel(_on(cuda, scan))
        cpu = intra_cuda.intra_scan_plain(*_on("cpu", scan))
        for g, w_ in zip(got, cpu):
            assert torch.equal(g.cpu(), w_)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_chain_probe_sees_every_store(cuda, mode):
    """The chain probe's rounds (shared memory, global through L1, global
    through L2) each read the sample another warp stored in the round:
    after R rounds thread t holds ((t + 32 R) mod n) + R, and the clock
    span is positive."""
    n, rounds = 256, 37
    buf = torch.zeros(2 * n, dtype=torch.int32, device=cuda)
    cyc = torch.zeros(1, dtype=torch.int64, device=cuda)
    rc = _build.lib().tde_chain_probe(
        buf.data_ptr(), n, rounds, mode, cyc.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check_launch("tde_chain_probe", rc)
    torch.cuda.synchronize()
    t = np.arange(n)
    want = (t + 32 * rounds) % n + rounds
    np.testing.assert_array_equal(
        buf[(rounds & 1) * n:(rounds & 1) * n + n].cpu().numpy(), want)
    assert int(cyc.item()) > 0
