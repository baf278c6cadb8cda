"""Coefficient densify (kernel B4's plain version) vs the JAX package: the
XLA formulation of the fused program (fused_decode._expand_feed + the dense
scatter), the Pallas kernel in interpret mode and the numpy oracle, at the
shapes of tests/test_coef_pallas.py; all bins of a picture in one call
(densify_bins); the escape corrections vs the JAX program's expression.
The residual bins (coef_cuda.residual_bins: escapes, dequant + inverse
transform, bypass, RDPCM) on the CPU vs the composition of
ops/transform.py and vs the JAX package's residual_batch, and the checks
of its wrapper.  On a CUDA card each kernel is held against its plain
version, the residual bins also at worst-case magnitudes and through
FusedDecoder (one launch a picture)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libde265_tpu import fused_decode as jfd
from libde265_tpu.ops import coef_pallas as cp
from libde265_tpu.ops import transform as jtx

from libde265_tpu_torch import FusedDecoder
from libde265_tpu_torch.decoder import (TU_INTRA, TU_RDPCM, TU_RDPCM_VERTICAL,
                                        TU_TQ_BYPASS, TU_TRANSFORM_SKIP,
                                        TU_USE_DST)
from libde265_tpu_torch.ops import coef_cuda
from libde265_tpu_torch.ops import transform as ttx

from _torch_common import (bytes_to_words, cuda, encode_csr,  # noqa: F401
                           gop_bytes, poison, programs, random_csr, t32)

SHAPES = {4: 77, 8: 41, 16: 13, 32: 9}


def _xla_levels(cv, coff, N, S):
    """The JAX program's non-Pallas densify (fused_decode.py:1083-1087)."""
    feed = {f"bin{S.bit_length() - 1}": {"cv": jnp.asarray(cv),
                                         "coff": jnp.asarray(coff)}}
    jfd._expand_feed(feed)
    bf = next(iter(feed.values()))
    levels = jnp.zeros((N, S, S), jnp.int32)
    return levels.at[bf["crow"], bf["cpos"] >> 6, bf["cpos"] & 63].set(
        bf["cval"], mode="drop", unique_indices=True)


def _pallas(cv, coff, N, S):
    cap = int(max((coff[1:N + 1] - coff[:N]).max(initial=4), 4))
    return np.asarray(cp.densify_bin(jnp.asarray(cv), jnp.asarray(coff), N=N,
                                     S=S, CAP=1 << (cap - 1).bit_length(),
                                     interpret=True))


def _cases():
    rng = np.random.default_rng(77)
    out = []
    for S, N in SHAPES.items():
        cv, coff = random_csr(rng, N, S, max_nnz=S * S)
        out.append((f"random-{S}", cv, coff, N, S))
    # long gaps: single far coefficients force chains of zero bytes
    bs, offs = [], [0]
    for _ in range(8):
        e = encode_csr([int(rng.integers(32 * 32 - 64, 32 * 32))],
                       [int(rng.integers(1, 8))])
        bs.extend(e)
        offs.append(offs[-1] + len(e))
    out.append(("long-gaps", bytes_to_words(bs), np.array(offs, np.int32), 8,
                32))
    # watermark padding: coff rows past the real TUs repeat the total
    cv, coff = random_csr(rng, 10, 8, max_nnz=12)
    coff = np.concatenate([coff, np.full(32 + 1 - len(coff), coff[-1],
                                         np.int32)])
    out.append(("padded-rows", cv, coff, 32, 8))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_densify_plain_matches_jax(case):
    _, cv, coff, N, S = case
    got = coef_cuda.densify_bin(t32(cv), t32(coff), N=N, S=S).numpy()
    np.testing.assert_array_equal(got, cp.densify_ref(cv, coff, N=N, S=S))
    np.testing.assert_array_equal(got, np.asarray(_xla_levels(cv, coff, N, S)))
    np.testing.assert_array_equal(got, _pallas(cv, coff, N, S))


def test_densify_empty_bin():
    got = coef_cuda.densify_bin(t32(np.zeros(0)), t32(np.zeros(1)), N=0, S=4)
    assert got.shape == (0, 4, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_densify_kernel_matches_plain(cuda, case):  # noqa: F811
    _, cv, coff, N, S = case
    n0 = coef_cuda.launches
    got = coef_cuda.densify_bin(t32(cv, cuda), t32(coff, cuda), N=N, S=S)
    want = coef_cuda.densify_bin_plain(t32(cv, cuda), t32(coff, cuda), N, S)
    torch.cuda.synchronize()
    assert coef_cuda.launches == n0 + 1
    assert torch.equal(got, want)


def _picture_bins(seed):
    """One picture's four bins (numpy cv, coff, N, S): S = 4 with padding
    rows, S = 8 empty, S = 16 with a TU whose entries run past S*S and a
    last run that ends past cv, S = 32 with long zero-byte gaps."""
    rng = np.random.default_rng(seed)
    cv4, coff4 = random_csr(rng, 90, 4, max_nnz=16)
    coff4 = np.concatenate([coff4, np.full(38, coff4[-1], np.int32)])
    bins = [(cv4, coff4, 127, 4),
            (np.zeros(0, np.int32), np.zeros(1, np.int32), 0, 8)]
    cv, coff = random_csr(rng, 13, 16, max_nnz=256)
    bs = list(cv.view(np.uint8))
    # positions 10, then 10 + 20 * 15 + 4 = 314 >= 256 (dropped)
    past = [9 | (3 << 4)] + [0] * 20 + [3 | (5 << 4), 0, 0]
    tail = [0] * 7 + [2 | ((-4 & 0xF) << 4)] * 9     # 16 entries
    bs += past + tail
    offs = list(coff) + [len(cv) * 4 + len(past), len(bs)]
    cut = 2       # the last TU's run ends two words past cv
    bins.append((bytes_to_words(bs)[:-cut], np.array(offs, np.int32), 15,
                 16))
    bs, offs = [], [0]
    for _ in range(9):
        e = encode_csr(sorted(rng.choice(1024, 3, replace=False)),
                       rng.integers(1, 8, 3))
        bs.extend(e)
        offs.append(offs[-1] + len(e))
    bins.append((bytes_to_words(bs), np.array(offs, np.int32), 9, 32))
    return bins


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_densify_bins_plain_matches_jax(seed):
    bins = _picture_bins(seed)
    buf, views = coef_cuda.densify_bins(
        [(t32(cv), t32(coff), N, S) for cv, coff, N, S in bins])
    assert buf.shape == (sum(N * S * S for *_, N, S in bins) + 1,)
    assert buf[-1] == 0
    off = 0
    for (cv, coff, N, S), v in zip(bins, views):
        assert v.shape == (N, S, S)
        assert v.untyped_storage().data_ptr() == \
            buf.untyped_storage().data_ptr() and v.storage_offset() == off
        off += N * S * S
        # the oracle walks every entry of a run: cv zero-padded past its
        # end (zero bytes write nothing)
        padded = np.concatenate([cv, np.zeros(int(coff[N]) // 4 + 1,
                                              np.int32)])
        np.testing.assert_array_equal(v.numpy(),
                                      cp.densify_ref(padded, coff, N=N, S=S))
        if N:
            np.testing.assert_array_equal(v.numpy(), _pallas(cv, coff, N, S))


def test_densify_bins_rejects_bad_bins():
    cv, coff = t32(np.zeros(4)), t32(np.zeros(3))
    with pytest.raises(ValueError):
        coef_cuda.densify_bins([(cv, coff, 2, 4)] * 5)
    with pytest.raises(ValueError):
        coef_cuda.densify_bins([(cv, coff, 2, 2)])
    with pytest.raises(ValueError):
        coef_cuda.densify_bins([(cv, coff, 3, 4)])


def test_escape_corrections_match_jax():
    """coef_cuda._add_escapes (in place into the picture's buffer)
    against the JAX program's correction (libde265_tpu/fused_decode.py,
    the `"cfx" in bf` branch): escape positions, padding rows (cfx = -1)
    and one index past the bin."""
    rng = np.random.default_rng(11)
    shapes = [(4, 60), (8, 9), (32, 3)]
    levels = [rng.integers(-7, 8, (N, S, S)) for S, N in shapes]
    buf = t32(np.concatenate([lv.ravel() for lv in levels] + [[0]]))
    off = 0
    for (S, N), lv in zip(shapes, levels):
        n = N * S * S
        k = int(rng.integers(1, 12))
        cfx = np.concatenate([rng.choice(n, k, replace=False), [-1, -1, n]])
        cfv = np.concatenate([rng.integers(-600, 600, k),
                              rng.integers(1, 50, 3)])
        coef_cuda._add_escapes(buf, off, n, t32(cfx), t32(cfv))
        s = S
        cfx_j, cfv_j = jnp.asarray(cfx, jnp.int32), jnp.asarray(cfv, jnp.int32)
        rr = jnp.where(cfx_j >= 0, jnp.clip(cfx_j, 0) // (s * s), 1 << 30)
        pp = jnp.clip(cfx_j, 0) % (s * s)
        want = jnp.asarray(lv, jnp.int32).at[rr, pp // s, pp % s].add(
            cfv_j, mode="drop", unique_indices=True)
        np.testing.assert_array_equal(buf[off:off + n].view(N, S, S).numpy(),
                                      np.asarray(want))
        off += n


def _on_card(bins, dev):
    return [(t32(cv, dev), t32(coff, dev), N, S) for cv, coff, N, S in bins]


def _hd_bins(rng):
    """Four random bins at the 1080p main path's bin sizes."""
    return [(*random_csr(rng, N, S, max_nnz=S * S), N, S)
            for S, N in ((4, 4096), (8, 2048), (16, 512), (32, 128))]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2, 3, "1080p"])
def test_densify_bins_kernel_one_launch(cuda, seed):  # noqa: F811
    bins = (_hd_bins(np.random.default_rng(5)) if seed == "1080p" else
            _picture_bins(seed))
    args = _on_card(bins, cuda)
    poison(sum(N * S * S for *_, N, S in bins) + 1)
    n0 = coef_cuda.launches
    buf, views = coef_cuda.densify_bins(args)
    want, _ = coef_cuda.densify_bins_plain(args)
    torch.cuda.synchronize()
    assert coef_cuda.launches == n0 + 1
    assert torch.equal(buf, want)
    for v, (*_, N, S) in zip(views, bins):
        assert v.shape == (N, S, S)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(1, 1, 32), (7, 4, 64), (256, 32, 512),
                                  (32, 2, 128)])
def test_densify_bins_kernel_tile_shapes(cuda, tile):  # noqa: F811
    """Every (TUs of a tile, lanes a TU, threads) shape equals the plain
    version (the tile sweep runs these)."""
    tus, lanes, threads = tile
    bins = _picture_bins(4)
    args = _on_card(bins, cuda)
    saved = dict(coef_cuda.TILE), coef_cuda.THREADS
    try:
        for S in coef_cuda.TILE:
            coef_cuda.TILE[S] = (min(tus, 4096 // (S * S)), lanes)
        coef_cuda.THREADS = threads
        poison(sum(N * S * S for *_, N, S in bins) + 1)
        buf, _ = coef_cuda.densify_bins(args)
        want, _ = coef_cuda.densify_bins_plain(args)
        torch.cuda.synchronize()
    finally:
        coef_cuda.TILE.update(saved[0])
        coef_cuda.THREADS = saved[1]
    assert torch.equal(buf, want)


@pytest.mark.gpu
def test_densify_bins_all_empty(cuda):  # noqa: F811
    """Bins with no TU: one launch still writes the scratch element."""
    z = t32(np.zeros(1), cuda)
    poison(1)
    n0 = coef_cuda.launches
    buf, views = coef_cuda.densify_bins([(z, z, 0, 4), (z, z, 0, 32)])
    torch.cuda.synchronize()
    assert coef_cuda.launches == n0 + 1
    assert buf.tolist() == [0] and [v.shape for v in views] == [
        (0, 4, 4), (0, 32, 32)]


# ---------------------------------------------------------------------------
# the residual bins: escapes, dequant + inverse transform, bypass, RDPCM
# ---------------------------------------------------------------------------

RES_DEPTHS = [(8, 8), (10, 10), (8, 10)]
RES_CASES = [(d, sc) for d in RES_DEPTHS for sc in (False, True)]
RES_IDS = [f"{bd}-{bdc}-{'lists' if sc else 'flat'}"
           for (bd, bdc), sc in RES_CASES]


def _res_picture(seed, depths, scaling, sizes=((2, 45), (3, 23), (4, 9),
                                               (5, 5))):
    """A picture's residual bins as the feed gives them to residual_bins
    (numpy): per (lg, N) the dense levels (4-bit wire values, the escapes
    applied by cfx/cfv, sorted, then three padding rows), the TU fields
    with every flag mixed (DST, transform skip, bypass, RDPCM both ways),
    cidx where the depths differ, the last TUs of a bin padding (QP 0, no
    levels); and the scaling tables (None for flat)."""
    rng = np.random.default_rng(seed)
    bd, bdc = depths
    bins = []
    for lg, N in sizes:
        S = 1 << lg
        lev = rng.integers(-7, 8, (N, S, S))
        lev[rng.random((N, S, S)) < 0.75] = 0
        lev[N - 2:] = 0
        flat = lev.reshape(-1)
        k = min(int(rng.integers(N, 3 * N)), flat.size // 4)
        pos = np.sort(rng.choice((N - 2) * S * S, k, replace=False))
        want = rng.integers(8, 32768, k) * rng.choice([-1, 1], k)
        want[want == 32767 * -1] = -32768
        flat[pos] = np.clip(want, -7, 7)
        cfx = np.concatenate([pos, [-1, -1, -1]])
        cfv = np.concatenate([want - flat[pos], rng.integers(1, 99, 3)])
        qp = rng.integers(0, 52 + 6 * (max(bd, bdc) - 8), N)
        f = np.zeros(N, np.int64)
        f |= (rng.random(N) < 0.2) * TU_TRANSFORM_SKIP
        f |= (rng.random(N) < 0.15) * TU_TQ_BYPASS
        f |= (rng.random(N) < 0.5) * TU_USE_DST
        f |= (rng.random(N) < 0.4) * TU_RDPCM
        f |= (rng.random(N) < 0.5) * TU_RDPCM_VERTICAL
        f |= (rng.random(N) < 0.5) * TU_INTRA
        qp[N - 2:], f[N - 2:] = 0, 0
        b = {"qp": qp, "flags": f, "mid": rng.integers(0, 6 if lg < 5 else 2,
                                                       N),
             "cfx": cfx, "cfv": cfv}
        if bd != bdc:
            b["cidx"] = rng.integers(0, 3, N)
        bins.append((lg, lev, b))
    sft = None
    if scaling:
        sft = [rng.integers(1, 256, (6, 1 << lg, 1 << lg)) for lg in
               (2, 3, 4, 5)]
    return bins, sft


def _res_args(pic, device="cpu"):
    """residual_bins' arguments for a _res_picture on device."""
    bins, sft = pic
    buf = torch.cat([t32(np.concatenate([lev.reshape(-1) for _, lev, _ in
                                         bins] + [[0]]), device)]).clone()
    args = [(lg, {k: t32(v, device) for k, v in b.items()})
            for lg, _, b in bins]
    return buf, args, None if sft is None else [t32(t, device) for t in sft]


def _res_expected(pic, depths, batch):
    """The residuals of a _res_picture by the per-bin composition on the
    host: the escapes added to the levels, batch(levels, qp, tskip,
    use_dst, lg, bit_depth, sf) for each depth (each TU at its channel's),
    the levels of bypass TUs, RDPCM by numpy prefix sums."""
    bins, sft = pic
    bd, bdc = depths
    out = []
    for lg, lev, b in bins:
        N, S = lev.shape[0], 1 << lg
        levels = lev.copy().reshape(-1)
        ok = (b["cfx"] >= 0) & (b["cfx"] < levels.size)
        np.add.at(levels, b["cfx"][ok], b["cfv"][ok])
        levels = levels.reshape(N, S, S)
        f = b["flags"]
        tskip, bypass = (f & TU_TRANSFORM_SKIP) != 0, (f & TU_TQ_BYPASS) != 0
        sf = None if sft is None else sft[lg - 2][b["mid"]]
        res = batch(levels, b["qp"], tskip, (f & TU_USE_DST) != 0, lg, bd, sf)
        if bd != bdc:
            res_c = batch(levels, b["qp"], tskip, (f & TU_USE_DST) != 0, lg,
                          bdc, sf)
            res = np.where((b["cidx"] != 0)[:, None, None], res_c, res)
        base = np.where(bypass[:, None, None], levels, res).astype(np.int64)
        rd = ((f & TU_RDPCM) != 0) & (tskip | bypass)
        vert = (f & TU_RDPCM_VERTICAL) != 0
        cs = np.where(vert[:, None, None], np.cumsum(base, 1),
                      np.cumsum(base, 2))
        out.append(np.where(rd[:, None, None], cs, base))
    return out


def _torch_batch(levels, qp, tskip, use_dst, lg, bd, sf):
    kw = {} if sf is None else {"sf": t32(sf), "qp": t32(qp)}
    return ttx.residual_batch(t32(levels), ttx.qp_to_fact(t32(qp)),
                              t32(tskip), t32(use_dst), lg, bd,
                              **kw).numpy()


def _jax_batch(levels, qp, tskip, use_dst, lg, bd, sf):
    j = lambda a: jnp.asarray(a, jnp.int32)    # noqa: E731
    kw = {} if sf is None else {"sf": j(sf), "qp": j(qp)}
    return np.asarray(jtx.residual_batch(
        j(levels), jtx.qp_to_fact_jnp(j(qp)), jnp.asarray(tskip),
        jnp.asarray(use_dst), lg, bd, **kw))


@pytest.mark.parametrize("depths,scaling", RES_CASES, ids=RES_IDS)
def test_residual_bins_cpu_matches_composition(depths, scaling):
    """residual_bins on CPU tensors (its plain version) against the per-bin
    composition of ops/transform.residual_batch, every bin size 4-32;
    the escapes land in the buffer, the padding rows in its scratch."""
    pic = _res_picture(sum(depths) + scaling, depths, scaling)
    buf, args, sft = _res_args(pic)
    n0 = coef_cuda.transform_launches
    got = coef_cuda.residual_bins(buf, args, *depths, sft)
    assert coef_cuda.transform_launches == n0
    want = _res_expected(pic, depths, _torch_batch)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    esc = np.concatenate([lev.reshape(-1) for _, lev, _ in pic[0]])
    off = 0
    for _, lev, b in pic[0]:
        ok = b["cfx"] >= 0
        np.add.at(esc, b["cfx"][ok] + off, b["cfv"][ok])
        off += lev.size
    np.testing.assert_array_equal(buf[:-1].numpy(), esc)


@pytest.mark.parametrize("depths,scaling", RES_CASES, ids=RES_IDS)
def test_residual_bins_plain_matches_jax(depths, scaling):
    """residual_bins_plain against the JAX package's residual_batch per bin
    (and depth), with the escapes, bypass and RDPCM composed around it."""
    pic = _res_picture(7 * sum(depths) + scaling, depths, scaling)
    buf, args, sft = _res_args(pic)
    got = coef_cuda.residual_bins_plain(buf, args, *depths, sft)
    for g, w in zip(got, _res_expected(pic, depths, _jax_batch)):
        np.testing.assert_array_equal(g.numpy(), w)


def _bad_residual_args(what):
    pic = _res_picture(3, (8, 8), True, sizes=((2, 8), (4, 3)))
    buf, args, sft = _res_args(pic)
    bd = bdc = 8
    if what == "unaligned":
        buf = torch.cat([buf.new_zeros(1), buf])[1:]
    elif what == "buf-int64":
        buf = buf.long()
    elif what == "buf-length":
        buf = torch.cat([buf, buf.new_zeros(16)])
    elif what == "qp-length":
        args[0][1]["qp"] = args[0][1]["qp"][:-1]
    elif what == "flags-int64":
        args[1][1]["flags"] = args[1][1]["flags"].long()
    elif what == "cfv-missing":
        del args[0][1]["cfv"]
    elif what == "sf-shape":
        sft[2] = sft[2][:, :8]
    elif what == "lg":
        args[1] = (6, args[1][1])
    elif what == "five-bins":
        args = args * 3
    elif what == "depth":
        bd = 7
    return buf, args, bd, bdc, sft


@pytest.mark.parametrize("what", ["unaligned", "buf-int64", "buf-length",
                                  "qp-length", "flags-int64", "cfv-missing",
                                  "sf-shape", "lg", "five-bins", "depth"])
def test_residual_bins_rejects_bad_arguments(what):
    with pytest.raises(ValueError):
        coef_cuda.residual_bins(*_bad_residual_args(what))


@pytest.mark.gpu
@pytest.mark.parametrize("depths,scaling", RES_CASES, ids=RES_IDS)
def test_residual_bins_kernel_matches_plain(cuda, depths,  # noqa: F811
                                            scaling):
    """The kernel, one launch in place over the buffer, against the plain
    version on the card, bit for bit (random bins, then the same bins at
    the 1080p main path's bin sizes)."""
    for sizes in (((2, 45), (3, 23), (4, 9), (5, 5)),
                  ((2, 4096), (3, 2048), (4, 512), (5, 128))):
        pic = _res_picture(11 * sum(depths) + scaling, depths, scaling,
                           sizes)
        buf, args, sft = _res_args(pic, cuda)
        want = coef_cuda.residual_bins_plain(buf.clone(), args, *depths, sft)
        n0 = coef_cuda.transform_launches
        got = coef_cuda.residual_bins(buf, args, *depths, sft)
        torch.cuda.synchronize()
        assert coef_cuda.transform_launches == n0 + 1
        off = 0
        for g, w in zip(got, want):
            assert g.untyped_storage().data_ptr() == \
                buf.untyped_storage().data_ptr() and g.storage_offset() == off
            off += g.numel()
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("bd,qp", [(8, 51), (10, 63)])
def test_residual_bins_kernel_worst_case(cuda, bd, qp):  # noqa: F811
    """Levels +-32767 at the largest QP, so every coefficient clips to 16
    bits, each TU's signs those of one basis function of its matrix (the
    stage-1 sums reach their largest magnitude, all-+-90 rows at S = 32),
    in DCT, DST, transform-skip and bypass TUs, flat and with scaling
    lists of 255: the kernel equals the plain version bit for bit, so its
    int32 sums are exact."""
    from libde265_tpu_torch.ops.transform import DCT32, DST4, dct_matrix
    bins = []
    for lg, N in ((2, 64), (3, 32), (4, 32), (5, 32)):
        S = 1 << lg
        mats = [dct_matrix(S)] + ([DST4] if lg == 2 else [])
        lev = np.empty((N, S, S), np.int64)
        f = np.zeros(N, np.int64)
        for t in range(N):
            m = mats[t % len(mats)]
            i, j = t % S, (t // S) % S
            sgn = np.where(np.outer(m[:, i], m[:, j]) < 0, -1, 1)
            lev[t] = 32767 * sgn * (-1 if t % 3 == 2 else 1)
            f[t] = TU_USE_DST if m is DST4 else 0
        f[N - 4] |= TU_TRANSFORM_SKIP
        f[N - 3] |= TU_TQ_BYPASS
        bins.append((lg, lev, {"qp": np.full(N, qp), "flags": f,
                               "mid": np.zeros(N, np.int64)}))
    assert np.abs(DCT32).max() == 90
    for sft in (None, [np.full((6, 1 << lg, 1 << lg), 255) for lg in
                       (2, 3, 4, 5)]):
        buf, args, sf = _res_args((bins, sft), cuda)
        want = coef_cuda.residual_bins_plain(buf.clone(), args, bd, bd, sf)
        got = coef_cuda.residual_bins(buf, args, bd, bd, sf)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert max(int(w.abs().max()) for w in want) > 0


@pytest.mark.gpu
def test_residual_bins_one_launch_a_picture(cuda):  # noqa: F811
    """Through FusedDecoder on the card: one residual_bins launch a picture
    (every picture of the stream has residual bins), bit-exact."""
    _, progs = programs(gop_bytes("p-sao"))
    fd = FusedDecoder(device=cuda)
    fd.plan_stream(progs)
    for p in progs:
        n0 = coef_cuda.transform_launches
        got = fd.decode(p)
        torch.cuda.synchronize()
        assert coef_cuda.transform_launches == n0 + 1
        for c in range(3):
            np.testing.assert_array_equal(got[c].cpu().numpy(), p.planes[c])
