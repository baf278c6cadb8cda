"""Kernels B6 (border gather), B7 (window scatter) and the intra scan's
step of the port against the JAX package, bit-exact (tolerance 0:
integers).

The JAX side runs its Pallas kernels in interpret mode on the CPU
(``ops/intra_window_pallas``, ``fused_decode._wave_body(pallas=True)``);
the port's side runs the plain PyTorch versions.  The records are one
super-wave step of K disjoint blocks on a 128x192 plane (K <= 16), the
valid ones leading as the JAX gather requires; the `gpu`-marked tests
hold each CUDA kernel against its plain version on the card.  The schedule
tests check, on the intra records of real test streams, the invariants
that let the scan read a step's borders and store its blocks in one pass
and run a picture's steps with a block barrier between them.

The persistent scan (``intra_cuda.intra_scan``) is held against the JAX
program's whole scan (its padded-plane scan, the Pallas kernels in
interpret mode) on a seeded synthetic schedule with all four
luma sizes in shared steps (``chip_smoke.synthetic_intra``: no encoder
stream here has 4x4 or 32x32 intra blocks), and on the card against its
plain version on that schedule and on the scans captured from test streams.
"""
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libde265_tpu import fused_decode as jfd
from libde265_tpu.ops import intra_window_pallas as jiwp
from libde265_tpu.ops.intra_wave import build_mode_tables as jtables

from libde265_tpu_torch import FusedDecoder
from libde265_tpu_torch import fused_decode as tfd
from libde265_tpu_torch.feed import bin_depths
from libde265_tpu_torch.ops import intra_cuda
from libde265_tpu_torch.ops import intra_window as iw
from libde265_tpu_torch.ops.intra import ANGLE, INV_ANGLE
from libde265_tpu_torch.ops.intra_wave import build_mode_tables

from _torch_common import (  # noqa: F401
    CORPUS, REPO, cuda, gop_bytes, programs, t32)

sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the synthetic schedule, shared with the card)

H, W = 128, 192
SIZES = [4, 8, 16, 32]


def make_step(s, K, bit_depth=8, seed=0, partial=False):
    """One step's records: (plane [H, W], meta [K, 5], aw [K, 5],
    resid [K, s, s]).  Smooth plane plus noise (so the 32x32 bilinear
    smoothing triggers); the corner blocks of the picture are included;
    availability never covers out-of-picture samples (8.4.4.2.2) nor, as in
    a real step, samples of the step's own valid blocks."""
    rng = np.random.default_rng(seed * 97 + s + bit_depth)
    nb, n2 = 4 * s + 1, 2 * s
    sc = 1 << (bit_depth - 8)
    yy, xx = np.mgrid[0:H, 0:W]
    plane = ((60 + yy // 2 + xx // 3) * sc + rng.integers(0, 3 * sc, (H, W))
             ) % (1 << bit_depth)
    gw, gh = W // s, H // s
    forced = [gw - 1, (gh - 1) * gw, gh * gw - 1]
    cells = [c for c in rng.permutation(gw * gh) if c not in forced]
    cells = np.array(forced + cells)[:K]
    ys, xs = (cells // gw) * s, (cells % gw) * s
    n_valid = K * 2 // 3 if partial else K
    occ = np.zeros((H, W), bool)
    for y, x in zip(ys[:n_valid], xs[:n_valid]):
        occ[y:y + s, x:x + s] = True
    meta = np.zeros((K, 5), np.int64)
    meta[:, 0] = rng.integers(0, 35, K)
    meta[:, 1] = rng.integers(0, 4, K) if s < 32 else 0
    meta[:, 2], meta[:, 3] = ys, xs
    meta[:, 4] = ((rng.random(K) < 0.6) * 2 | (rng.random(K) < 0.5) * 4 | 8)
    aw = np.zeros((K, 5), np.int64)
    j = np.arange(nb)
    for k in range(K):
        by = np.where(j < n2, ys[k] + n2 - 1 - j, ys[k] - 1)
        bx = np.where(j <= n2, xs[k] - 1, xs[k] + j - n2 - 1)
        av = (rng.random(nb) < 0.8) | (rng.random() < 0.4)
        av &= (by >= 0) & (by < H) & (bx >= 0) & (bx < W)
        av &= ~occ[by.clip(0, H - 1), bx.clip(0, W - 1)]
        if rng.random() < 0.1 or not av.any():
            av[:] = False
            meta[k, 4] |= 1                       # unavailable border
        aw[k] = np.packbits(np.pad(av, (0, 160 - nb)),
                            bitorder="little").view(np.int32)
    meta[n_valid:] = 0
    aw[n_valid:] = 0
    resid = rng.integers(-40 * sc, 41 * sc, (K, s, s))
    return plane, meta, aw, resid


def _k(s):
    return min(jfd.WAVE_CAP[s.bit_length() - 1], 16)


def _padded_np(plane):
    hp, wp = iw.scan_pad_sizes(*plane.shape)
    assert (hp, wp) == jiwp.scan_pad_sizes(*plane.shape)
    return np.pad(plane, ((iw.PAD_T, hp - H - iw.PAD_T),
                          (iw.PAD_L, wp - W - iw.PAD_L)))


def _origins(meta):
    return meta[:, 2] + iw.PAD_T, meta[:, 3] + iw.PAD_L


CASES = [(s, partial) for s in SIZES for partial in (False, True)]
IDS = [f"s{s}-{'partial' if p else 'all'}" for s, p in CASES]


def test_pad_unpad_match_jax():
    plane = np.arange(H * W).reshape(H, W) % 251
    hp, wp = iw.scan_pad_sizes(H, W)
    got = iw.pad_plane_for_scan(t32(plane), hp, wp)
    want = jiwp.pad_plane_for_scan(jnp.asarray(plane, jnp.int32), hp=hp, wp=wp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(iw.unpad_plane(got, H, W).numpy(), plane)


@pytest.mark.parametrize("s,partial", CASES, ids=IDS)
def test_border_gather_matches_jax(s, partial):
    """Rows k < nvalid only: past nvalid the TPU kernel leaves clamped
    duplicates and the port zeros, and nothing reads either."""
    plane, meta, _, _ = make_step(s, _k(s), partial=partial)
    padded = _padded_np(plane)
    y0p, x0p = _origins(meta)
    nvalid = int(((meta[:, 4] & 8) != 0).sum())
    want = jiwp.border_gather(jnp.asarray(padded, jnp.int32),
                              jnp.asarray(y0p, jnp.int32),
                              jnp.asarray(x0p, jnp.int32), jnp.int32(nvalid),
                              s=s, interpret=True)
    got = iw.border_gather_plain(t32(padded), t32(y0p), t32(x0p), nvalid, s=s)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[:nvalid],
                                      np.asarray(w_)[:nvalid])
        assert not g.numpy()[nvalid:].any()


@pytest.mark.parametrize("s,partial", CASES, ids=IDS)
def test_window_scatter_matches_jax(s, partial):
    plane, meta, _, resid = make_step(s, _k(s), partial=partial)
    padded = _padded_np(plane)
    y0p, x0p = _origins(meta)
    valid = (meta[:, 4] & 8) != 0
    blocks = resid + 500
    want = jiwp.window_scatter(jnp.asarray(padded, jnp.int32),
                               jnp.asarray(blocks, jnp.int32),
                               jnp.asarray(y0p, jnp.int32),
                               jnp.asarray(x0p, jnp.int32),
                               jnp.asarray(valid), s=s, interpret=True)
    dst = t32(padded)
    got = iw.window_scatter_plain(dst, t32(blocks), t32(y0p), t32(x0p),
                                  t32(valid), s=s)
    assert got.data_ptr() == dst.data_ptr()          # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), padded)


def _step_args(s, meta, aw, resid):
    """The records as one bin's scan arrays: 2 steps, the data in step 1,
    residual rows reversed and some blocks without a residual."""
    K = meta.shape[0]
    meta_all = np.zeros((2, K, 5), np.int64)
    meta_all[1] = meta
    aw_all = np.zeros((2, K, 5), np.int64)
    aw_all[1] = aw
    rrow_all = np.full((2, K), -1, np.int64)
    rrow_all[1] = K - 1 - np.arange(K)
    rrow_all[1, ::5] = -1
    res = resid[::-1].copy()
    return [t32(a) for a in (meta_all, rrow_all, aw_all, res)]


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("s", SIZES)
def test_intra_step_matches_jax_wave_body(s, bit_depth):
    """The port's intra step on the padded plane against the JAX program's
    step on it (_wave_body with the Pallas gather and scatter)."""
    plane, meta, aw, resid = make_step(s, _k(s), bit_depth, seed=1,
                                       partial=True)
    padded = _padded_np(plane)
    meta_all, rrow_all, aw_all, res = _step_args(s, meta, aw, resid)
    rr = rrow_all[1].numpy()
    jres = np.where((rr >= 0)[:, None, None], res.numpy()[np.clip(rr, 0, None)],
                    0)
    want = jfd._wave_body(jnp.asarray(padded, jnp.int32),
                          jnp.asarray(meta, jnp.int32),
                          jnp.asarray(aw, jnp.int32),
                          jnp.asarray(jres, jnp.int32),
                          *(jnp.asarray(t) for t in jtables(s)), s=s,
                          bit_depth=bit_depth, pallas=True, interpret=True)
    got = intra_cuda.intra_step_plain(
        t32(padded), meta_all, rrow_all, aw_all, 1, res,
        *(t32(t) for t in build_mode_tables(s)), s=s, bit_depth=bit_depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), padded)


def _stream_bytes(stream):
    """A test GOP by name, or "104x72": the corpus stream
    conf_window_104x72 (scripts/make_corpus.py: CTB 64, intra period 4), the
    one geometry here with two intra block sizes per plane; a stream's
    bytes as they are."""
    if isinstance(stream, bytes):
        return stream
    if stream == "104x72":
        return (CORPUS / "conf_window_104x72.h265").read_bytes()
    return gop_bytes(stream)


def _scan_bins(monkeypatch, stream):
    """Each intra scan of a stream decoded on the CPU, as _intra_scan_all
    gets it: [(plane shapes, {c: {lg: bin}}, nsteps)], bins as numpy;
    "synthetic": the one scan of chip_smoke.synthetic_intra(0)."""
    if stream == "synthetic":
        planes, irec, nsteps, _ = chip_smoke.synthetic_intra(0)
        bins = tuple(sorted({(("y", "cb", "cr")[c], lg)
                             for c, lg in irec[:, 8:10].tolist()}))
        by_plane = intra_cuda.scatter_records(
            torch.from_numpy(irec), bins, int(irec[:, 6].max()) + 1,
            bin_depths(irec[:, 8], irec[:, 9], irec[:, 6]))
        return [([p.shape for p in planes],
                 {c: {lg: {"meta": v["meta"].numpy(), "aw": v["aw"].numpy(),
                           "depth": v["depth"]} for lg, v in b.items()}
                  for c, b in by_plane.items()}, nsteps)]
    _, progs = programs(_stream_bytes(stream))
    seen = []
    scan = tfd._intra_scan_all

    def record(planes, bins_by_plane, bin_res, st, nsteps):
        seen.append(([tuple(p.shape) for p in planes],
                     {c: {lg: {"meta": v["meta"].numpy().copy(),
                               "aw": v["aw"].numpy().copy(),
                               "depth": v["depth"]}
                          for lg, v in b.items()}
                      for c, b in bins_by_plane.items()}, nsteps))
        return scan(planes, bins_by_plane, bin_res, st, nsteps)

    monkeypatch.setattr(tfd, "_intra_scan_all", record)
    fd = FusedDecoder(device="cpu")
    fd.plan_stream(progs)
    for prog in progs:
        fd.decode(prog)
    return seen


def _border_cells(meta, aw, s, h, w):
    """Available border samples of a step's valid blocks: (rows, cols,
    availability [n, 4s+1], inside the plane [n, 4s+1])."""
    nb, n2 = 4 * s + 1, 2 * s
    j = np.arange(nb)
    ys, xs = meta[:, 2], meta[:, 3]
    av = np.unpackbits(np.ascontiguousarray(aw).astype(np.int32).view(
        np.uint8), axis=1, bitorder="little")[:, :nb].astype(bool)
    by = np.where(j < n2, ys[:, None] + n2 - 1 - j, ys[:, None] - 1)
    bx = np.where(j <= n2, xs[:, None] - 1, xs[:, None] + j - n2 - 1)
    inside = (by >= 0) & (by < h) & (bx >= 0) & (bx < w)
    return by.clip(0, h - 1), bx.clip(0, w - 1), av, inside


@pytest.mark.parametrize("stream", ["all-intra", "p-sao", "10bit", "tiles"])
def test_schedule_borders_avoid_own_step(native_build, monkeypatch, stream):
    """Within one (plane, size, step) bin no block has an available border
    sample inside a valid block of that bin, nor outside the picture: the
    schedule's rule within one bin (test_schedule_reads_only_earlier_steps
    checks it across the bins of a plane, the invariant of the scan kernels
    in csrc/intra.cu)."""
    checked = shared = 0
    for shapes, bins, nsteps in _scan_bins(monkeypatch, stream):
        for c, by_lg in bins.items():
            if c >= len(shapes):
                continue
            h, w = shapes[c]
            for lg, v in by_lg.items():
                s = 1 << lg
                nb, n2 = 4 * s + 1, 2 * s
                j = np.arange(nb)
                for i in range(min(v["depth"], int(np.max(nsteps)))):
                    meta, aw = v["meta"][i], v["aw"][i]
                    valid = (meta[:, 4] & 8) != 0
                    if not valid.any():
                        continue
                    ys, xs = meta[valid, 2], meta[valid, 3]
                    occ = np.zeros((h, w), bool)
                    for y, x in zip(ys, xs):
                        occ[y:y + s, x:x + s] = True
                    av = np.unpackbits(
                        np.ascontiguousarray(aw[valid]).astype(
                            np.int32).view(np.uint8), axis=1,
                        bitorder="little")[:, :nb].astype(bool)
                    by = np.where(j < n2, ys[:, None] + n2 - 1 - j,
                                  ys[:, None] - 1)
                    bx = np.where(j <= n2, xs[:, None] - 1,
                                  xs[:, None] + j - n2 - 1)
                    inside = (by >= 0) & (by < h) & (bx >= 0) & (bx < w)
                    assert not (av & ~inside).any(), (c, lg, i)
                    hit = occ[by.clip(0, h - 1), bx.clip(0, w - 1)]
                    assert not (av & inside & hit).any(), (c, lg, i)
                    checked += int(av.sum())
                    shared += int(valid.sum() > 1)
    assert checked and shared      # available samples, steps of >1 block


@pytest.mark.parametrize("stream", ["all-intra", "p-sao", "10bit", "tiles",
                                    "104x72", "synthetic"])
def test_schedule_reads_only_earlier_steps(native_build, monkeypatch,
                                           stream):
    """The invariant of the persistent scan kernel (csrc/intra.cu): within
    a plane, no available border sample of a step-i block lies outside the
    picture or in a block of step >= i of any size bin, so one CTA may run
    a plane's steps in order with a block barrier between them."""
    checked = 0
    bins_per_plane = shared_sizes = 0
    for shapes, bins, nsteps in _scan_bins(monkeypatch, stream):
        total = int(np.max(nsteps))
        for c, by_lg in bins.items():
            if c >= len(shapes):
                continue
            h, w = shapes[c]
            writer = np.full((h, w), -1)   # step of the block writing it
            steps = []
            for lg, v in by_lg.items():
                s = 1 << lg
                for i in range(min(v["depth"], total)):
                    meta, aw = v["meta"][i], v["aw"][i]
                    valid = (meta[:, 4] & 8) != 0
                    for y, x in meta[valid, 2:4]:
                        assert (writer[y:y + s, x:x + s] < 0).all()
                        writer[y:y + s, x:x + s] = i
                    if valid.any():
                        steps.append((s, i, meta[valid], aw[valid]))
            sizes = {}
            for s, i, meta, aw in steps:
                by, bx, av, inside = _border_cells(meta, aw, s, h, w)
                assert not (av & ~inside).any(), (c, s, i)
                assert not (av & (writer[by, bx] >= i)).any(), (c, s, i)
                checked += int(av.sum())
                sizes.setdefault(i, set()).add(s)
            bins_per_plane = max(bins_per_plane, len(by_lg))
            shared_sizes = max([shared_sizes] + [len(v) for v in
                                                 sizes.values()])
    assert checked
    if stream in ("104x72", "synthetic"):   # several size bins in one step
        assert bins_per_plane >= 2 and shared_sizes >= 2
    if stream == "synthetic":
        assert bins_per_plane == 4 and shared_sizes == 4


def _synthetic_scan(bit_depth, seed=0):
    """chip_smoke.synthetic_intra as the picture program's scan inputs on
    the CPU: (planes, bins, bin_res, st, nsteps, irec)."""
    planes, irec, nsteps, res = chip_smoke.synthetic_intra(
        seed, bit_depth=bit_depth)
    bins = tuple(sorted({(("y", "cb", "cr")[c], lg)
                         for c, lg in irec[:, 8:10].tolist()}))
    st = {"bd": bit_depth, "bdc": bit_depth, "pallas_intra": True,
          "pallas_interp": True, "intra_bins": bins,
          "steps_cap": int(irec[:, 6].max()) + 1}
    return planes, bins, res, st, nsteps, irec


def test_intra_scan_multi_size_matches_jax():
    """The whole scan of a synthetic picture whose steps share all four
    luma sizes (chroma 4 to 16): the port's padded-plane scan
    (intra_cuda.intra_scan, its plain version on the CPU) against the JAX
    program's (its padded-plane scan, the Pallas gather and scatter in
    interpret mode), bit-exact."""
    planes, bins, res, st, nsteps, irec = _synthetic_scan(8)
    by_step = {}
    for c, lg, i in irec[:, [8, 9, 6]].tolist():
        by_step.setdefault((c, i), set()).add(lg)
    assert {2, 3, 4, 5} in by_step.values()
    jb = jfd._scatter_intra_bins(jnp.asarray(irec), bins, st["steps_cap"])
    want = jfd._intra_scan_all([jnp.asarray(p) for p in planes], jb,
                               {lg: jnp.asarray(r) for lg, r in res.items()},
                               st, jnp.asarray(nsteps))
    tb = intra_cuda.scatter_records(
        torch.from_numpy(irec), bins, st["steps_cap"],
        bin_depths(irec[:, 8], irec[:, 9], irec[:, 6]))
    got = tfd._intra_scan_all([torch.from_numpy(p) for p in planes], tb,
                              {lg: torch.from_numpy(r)
                               for lg, r in res.items()}, st, nsteps)
    for c, (g, w_) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_),
                                      err_msg=f"plane {c}")
        assert not np.array_equal(g.numpy(), planes[c])


def _kernel_angular_refs(s):
    """The angular reference indices and weights as the scan kernel
    computes them for each sample (csrc/intra.cu run_blocks: the border
    index of the reference array's entry ref[i], read at i0 = idx + 1 + x
    or y and i0 + 1): (P0, P1, WT) [35, s*s] for modes 2-34 (rows 0 and 1
    zero: planar and DC read no table)."""
    n2 = 2 * s
    y, x = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    out = np.zeros((3, 35, s * s), np.int64)
    for mode in range(2, 35):
        angle, inv, vert = int(ANGLE[mode]), int(INV_ANGLE[mode]), mode >= 18
        t = ((y if vert else x) + 1) * angle
        i0 = (t >> 5) + 1 + (x if vert else y)

        def ref(i):
            off = (i * inv + 128) >> 8
            neg = np.maximum(n2 - off, 0) if vert else np.minimum(n2 + off,
                                                                  4 * s)
            return np.where(i >= 0, n2 + i if vert else n2 - i, neg)

        out[:, mode] = ref(i0).ravel(), ref(i0 + 1).ravel(), (t & 31).ravel()
    return out


@pytest.mark.parametrize("s", SIZES)
def test_kernel_angular_reference_matches_mode_tables(s):
    """The angular reference indices and weights that the scan kernels
    compute from the mode's angle (transcribed from csrc/intra.cu in
    _kernel_angular_refs) equal the port's and the JAX package's
    build_mode_tables for every angular mode and every sample (an index
    outside the border reads 0 in both).  The kernel itself is held
    against its plain version by the `gpu` scan tests."""
    got = _kernel_angular_refs(s)
    for tabs in (build_mode_tables(s), jtables(s)):
        for g, want in zip(got, tabs):
            np.testing.assert_array_equal(g[2:], np.asarray(want)[2:])


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (skip without a card)
# ---------------------------------------------------------------------------

def _on(dev, scan):
    """A captured scan's arguments moved to `dev` (planes cloned)."""
    padded, bins, bin_res, tables, nsteps, bds = scan
    return ([p.clone().to(dev) for p in padded],
            {c: {lg: {k: (x.to(dev) if torch.is_tensor(x) else x)
                      for k, x in v.items()} for lg, v in b.items()}
             for c, b in bins.items()},
            {lg: r.to(dev) for lg, r in bin_res.items()},
            {lg: tuple(t.to(dev) for t in tabs)
             for lg, tabs in tables.items()}, nsteps, bds)


def _check_scan_kernel(args):
    """intra_scan (one launch) against intra_scan_plain on the same
    arguments; returns the kernel's planes."""
    before = intra_cuda.scan_launches
    got = intra_cuda.intra_scan([p.clone() for p in args[0]], *args[1:])
    assert intra_cuda.scan_launches == before + 1
    want = intra_cuda.intra_scan_plain([p.clone() for p in args[0]],
                                       *args[1:])
    torch.cuda.synchronize()
    for c, (g, w_) in enumerate(zip(got, want)):
        assert torch.equal(g, w_), f"plane {c}"
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("seed", [0, 1])
def test_intra_scan_kernel_synthetic(cuda, seed, bit_depth):
    _check_scan_kernel(chip_smoke.synthetic_scan_inputs(seed, cuda,
                                                        bit_depth=bit_depth))


@pytest.mark.gpu
def test_intra_scan_rejects_unaligned_records(cuda):
    """The kernel copies records 16 bytes at a time: records that are not
    16-byte aligned, or whose slot count is not a multiple of 4, raise
    before any launch."""
    args = chip_smoke.synthetic_scan_inputs(0, cuda)
    bins = args[1]
    c, lg = 0, min(bins[0])
    v = bins[c][lg]
    before = intra_cuda.scan_launches
    shifted = torch.empty(v["meta"].numel() + 1, dtype=torch.int32,
                          device=cuda)[1:].view(v["meta"].shape)
    shifted.copy_(v["meta"])
    bad = {**bins, c: {**bins[c], lg: {**v, "meta": shifted}}}
    with pytest.raises(ValueError, match="aligned"):
        intra_cuda.intra_scan(args[0], bad, *args[2:])
    narrow = {k: (x[:, :-1].contiguous() if k in ("meta", "rrow", "aw")
                  else x) for k, x in v.items()}
    bad = {**bins, c: {**bins[c], lg: narrow}}
    with pytest.raises(ValueError, match="bad records"):
        intra_cuda.intra_scan(args[0], bad, *args[2:])
    assert intra_cuda.scan_launches == before


def _capture_scans(monkeypatch, stream):
    """The intra_cuda.intra_scan arguments of each picture of a stream that
    has intra steps (a CPU decode), the padded planes as they were before
    the scan."""
    _, progs = programs(_stream_bytes(stream))
    seen = []
    scan = intra_cuda.intra_scan

    def record(padded, bins_by_plane, bin_res, tables, nsteps, bit_depths):
        if len(nsteps) and int(np.max(nsteps)) > 0:   # else no launch
            seen.append(([p.clone() for p in padded], bins_by_plane,
                         dict(bin_res), dict(tables), np.array(nsteps),
                         list(bit_depths)))
        return scan(padded, bins_by_plane, bin_res, tables, nsteps,
                    bit_depths)

    monkeypatch.setattr(intra_cuda, "intra_scan", record)
    fd = FusedDecoder(device="cpu")
    fd.plan_stream(progs)
    for prog in progs:
        fd.decode(prog)
    monkeypatch.undo()
    return seen


@pytest.mark.gpu
@pytest.mark.parametrize("stream", ["104x72", "10bit", "all-intra"])
def test_intra_scan_kernel_captured(cuda, native_build, monkeypatch, stream):
    """Every intra scan of a stream: the kernel against its plain version
    on the card, and against the CPU decode's scan."""
    scans = _capture_scans(monkeypatch, stream)
    assert scans
    for scan in scans:
        got = _check_scan_kernel(_on(cuda, scan))
        cpu = intra_cuda.intra_scan_plain(*_on("cpu", scan))
        for g, w_ in zip(got, cpu):
            assert torch.equal(g.cpu(), w_)


@pytest.mark.gpu
@pytest.mark.parametrize("s", SIZES)
def test_border_gather_kernel(cuda, s):
    plane, meta, _, _ = make_step(s, jfd.WAVE_CAP[s.bit_length() - 1],
                                  partial=True)
    padded = t32(_padded_np(plane), cuda)
    y0p, x0p = (t32(a, cuda) for a in _origins(meta))
    nvalid = int(((meta[:, 4] & 8) != 0).sum())
    got = iw.border_gather(padded, y0p, x0p, nvalid, s=s)
    want = iw.border_gather_plain(padded, y0p, x0p, nvalid, s=s)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@pytest.mark.gpu
@pytest.mark.parametrize("s", SIZES)
def test_window_scatter_kernel(cuda, s):
    plane, meta, _, resid = make_step(s, jfd.WAVE_CAP[s.bit_length() - 1],
                                      partial=True)
    padded = t32(_padded_np(plane), cuda)
    y0p, x0p = (t32(a, cuda) for a in _origins(meta))
    valid = t32((meta[:, 4] & 8) != 0, cuda)
    blocks = t32(resid + 500, cuda)
    got = iw.window_scatter(padded.clone(), blocks, y0p, x0p, valid, s=s)
    want = iw.window_scatter_plain(padded.clone(), blocks, y0p, x0p, valid,
                                   s=s)
    assert torch.equal(got, want)

