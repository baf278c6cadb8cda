"""The production formulation's kernels (B3 segment MC, B2 PU paint, B5
residual stripes, B1 feed expander) and their host planning, against the
JAX package: the plain PyTorch versions against the Pallas kernels in
interpret mode (built as tests/test_mc_pallas.py builds them), the host
helpers array for array.  Tolerance 0 everywhere (integer math).  On a CUDA
card each kernel is held against its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libde265_tpu import fused_decode as jfd
from libde265_tpu.decoder import PU_DTYPE
from libde265_tpu.ops import mc_pallas as mp

from libde265_tpu_torch import fused_decode as tfd
from libde265_tpu_torch.ops import expand, mc_seg

from _torch_common import cuda, gop_bytes, programs, t32  # noqa: F401


def random_pus(rng, H, W, L=1, max_mv=40, n_slots=3):
    """A random partition of the picture into PUs (a quadtree of 64x64
    blocks, halves as 2-PU splits, about a fifth left as intra holes):
    disjoint, as in a real picture.  L=2: pred_flags 1..3."""
    recs = []

    def leaf(x, y, w, h):
        if rng.random() < 0.2:
            return
        r = np.zeros(1, PU_DTYPE)[0]
        r["x"], r["y"], r["w"], r["h"] = x, y, w, h
        r["pred_flags"] = int(rng.integers(1, 4)) if L == 2 else 1
        for l in (0, 1):
            r[f"mv{l}x"] = int(rng.integers(-max_mv * 4, max_mv * 4))
            r[f"mv{l}y"] = int(rng.integers(-max_mv * 4, max_mv * 4))
            r[f"ref_dpb{l}"] = int(rng.integers(0, n_slots))
        recs.append(r)

    def split(x, y, s):
        if x >= W or y >= H:
            return
        if s > 8 and (s > 32 or rng.random() < 0.5 or x + s > W or
                      y + s > H):
            for dy in (0, s // 2):
                for dx in (0, s // 2):
                    split(x + dx, y + dy, s // 2)
            return
        u = rng.random()
        if u < 0.3:
            leaf(x, y, s, s // 2)
            leaf(x, y + s // 2, s, s // 2)
        elif u < 0.6:
            leaf(x, y, s // 2, s)
            leaf(x + s // 2, y, s // 2, s)
        else:
            leaf(x, y, s, s)

    for y in range(0, H, 64):
        for x in range(0, W, 64):
            split(x, y, 64)
    return np.array(recs, PU_DTYPE)


def _ring(rng, R, H, W, bd):
    """R random planes, each replicate-padded into its slot by the JAX
    pad_plane; the port's pad_replicate must give the same slots."""
    ref = rng.integers(0, 1 << bd, (R, H, W)).astype(np.int32)
    hp, wp = mp.pad_sizes(H, W)
    assert (hp, wp) == mc_seg.pad_sizes(H, W)
    slots = np.stack([np.asarray(mp.pad_plane(jnp.asarray(r), hp, wp))
                      for r in ref])
    for r, want in zip(ref, slots):
        np.testing.assert_array_equal(
            tfd.pad_replicate(t32(r), hp, wp).numpy(), want)
    return slots.reshape(R * hp, wp), hp


# seeds x {luma, chroma} x {8, 10}-bit, a seed each (an interpret-mode
# compile costs seconds); the gpu test below takes all eight
MC_CASES = [(0, False, 8), (1, False, 10), (2, True, 8), (3, True, 10)]
ALL_MC = [(seed, chroma, bd) for seed in (0, 1) for chroma in (False, True)
          for bd in (8, 10)]


@pytest.mark.parametrize("seed,chroma,bd", MC_CASES)
def test_mc_stripes_plain_matches_jax(seed, chroma, bd):
    rng = np.random.default_rng(seed)
    H, W = 32, 96
    l = seed % 2
    pus = random_pus(rng, H, W, L=2)
    sub = 2
    Hd, Wd = (H // sub, W // sub) if chroma else (H, W)
    OR, T = (4 // sub, 4) if chroma else (4, 8)
    refs2d, hp = _ring(rng, 3, Hd, Wd, bd)
    counts, sidx, K = mp.plan_segment_indices(pus, l, H)
    assert counts.sum() > 0
    puw = mp.pus_to_wire(pus)
    n_bands, wout = H // 4, max(256, (Wd + 127) & ~127)
    kw = dict(OR=OR, T=T, Hpad=hp, Wout=wout, n_bands=n_bands, KMAX=K, bd=bd,
              chroma=chroma, Hdim=Hd, Wdim=Wd, sub_x=sub, sub_y=sub)
    want = np.asarray(mp.mc_stripes(
        jnp.asarray(refs2d), jnp.asarray(counts), jnp.asarray(sidx),
        mp.pack_pu_mc(jnp.asarray(puw), l), interpret=True, **kw))
    got = mc_seg.mc_stripes(t32(refs2d), t32(counts), t32(sidx), t32(puw),
                            list_idx=l, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,L", [(3, 1), (4, 2), (5, 2)])
def test_paint_pu_idx_plain_matches_jax(seed, L):
    rng = np.random.default_rng(seed)
    H, W = 64, 96
    pus = random_pus(rng, H, W, L=L)
    n_bands, W4 = H // 4, W // 4
    plans = [mp.plan_segment_indices(pus, l, H) for l in range(L)]
    kp = max(p[1].shape[1] for p in plans)
    sidx2 = np.zeros((n_bands, L, kp), np.int32)
    for l, (_, s, _) in enumerate(plans):
        sidx2[:, l, :s.shape[1]] = s
    nseg2 = np.stack([p[0] for p in plans])
    puw = mp.pus_to_wire(pus)
    want = np.asarray(mp.paint_pu_idx(
        jnp.asarray(nseg2), jnp.asarray(sidx2),
        mp.pack_pu_geo(jnp.asarray(puw)), n_bands=n_bands, W4=W4, L=L,
        interpret=True))
    got = mc_seg.paint_pu_idx(t32(nseg2), t32(sidx2), t32(puw),
                              n_bands=n_bands, W4=W4, L=L)
    np.testing.assert_array_equal(got.numpy(), want)
    # the host raster of the same partition
    exp = np.full((n_bands, W4), -1, np.int32)
    for i, p in enumerate(pus):
        exp[p["y"] // 4:(p["y"] + p["h"]) // 4,
            p["x"] // 4:(p["x"] + p["w"]) // 4] = i
    np.testing.assert_array_equal(want, exp)


def _residual_case(lg, OR):
    rng = np.random.default_rng(lg * 10 + OR)
    s = 1 << lg
    H, W = 64, 96 if OR == 4 else 48
    cells = [(x, y) for y in range(0, H - s + 1, s)
             for x in range(0, W - s + 1, s)]
    cells = [cells[i] for i in rng.permutation(len(cells))]
    N = min(9, len(cells))
    bin_res = rng.integers(-500, 500, (N + 3, s, s)).astype(np.int32)
    sc = np.array([[i, cells[i][0], cells[i][1]] for i in range(N)] +
                  [[-1, 0, 0]], np.int32)       # a padding row
    band, srow, x0 = mp.plan_residual_segments(sc, s, OR)
    cnt, sw, K = mp.pack_band_segments(band, srow, x0, H // OR)
    # a band's words beyond its count are padding
    sw = np.concatenate([sw, np.full((sw.shape[0], 2), 7 << 20, np.int32)], 1)
    return bin_res, cnt, sw, H, W, s, sc


@pytest.mark.parametrize("lg,OR", [(2, 4), (3, 4), (4, 4), (5, 4),
                                   (2, 2), (3, 2), (4, 2), (5, 2)])
def test_residual_stripes_plain_matches_jax(lg, OR):
    bin_res, cnt, sw, H, W, s, sc = _residual_case(lg, OR)
    n_bands, wout = H // OR, max(256, (W + 127) & ~127)
    want = np.asarray(mp.residual_stripes(
        jnp.asarray(bin_res), jnp.asarray(cnt), jnp.asarray(sw), OR=OR, S=s,
        Wout=wout, n_bands=n_bands, interpret=True))
    got = mc_seg.residual_stripes(t32(bin_res), t32(cnt), t32(sw), OR=OR,
                                  S=s, Wout=wout, n_bands=n_bands)
    np.testing.assert_array_equal(got.numpy(), want)
    exp = np.zeros((H, W), np.int32)
    for i, x, y in sc[sc[:, 0] >= 0]:
        exp[y:y + s, x:x + s] = bin_res[i]
    np.testing.assert_array_equal(
        want.reshape(n_bands * OR, wout)[:H, :W], exp)


def _residual_edge_case(case, lg, OR):
    """A bin at an awkward geometry: W = 1000 with Wout = 1024 and a TU in
    the last column ("ragged"), TUs only in the top quarter so most bands
    have no segment ("empty_bands"), no segment at all, as the feed ships
    the intra residual bins of an I picture ("all_zero"), or a TU in every
    other cell with random words beyond each band's count ("garbage")."""
    rng = np.random.default_rng([len(case), lg, OR])
    s = 1 << lg
    H, W = 32, 1000 if OR == 4 else 500
    Wout = 1024 if OR == 4 else 512
    gy, gx = H // s, W // s
    cells = [(x * s, y * s) for y in range(gy) for x in range(gx)]
    if case == "ragged":
        keep = [c for c in cells if c[0] == (gx - 1) * s] + \
            [cells[i] for i in rng.permutation(len(cells))[:8]]
    elif case == "empty_bands":
        keep = [c for c in cells if c[1] < max(H // 4, s)][::2]
    elif case == "all_zero":
        keep = []
    else:
        keep = cells[::2]
    keep = list(dict.fromkeys(keep))
    N = len(keep)
    bin_res = rng.integers(-500, 500, (N + 2, s, s)).astype(np.int32)
    sc = np.array([[i, x, y] for i, (x, y) in enumerate(keep)] +
                  [[-1, 0, 0]], np.int32).reshape(-1, 3)
    n_bands = H // OR
    band, srow, x0 = mp.plan_residual_segments(sc, s, OR)
    cnt, sw, K = mp.pack_band_segments(band, srow, x0, n_bands)
    if case == "garbage":
        sw = np.concatenate([sw, np.zeros((n_bands, 3), np.int32)], 1)
        for b in range(n_bands):
            sw[b, cnt[b]:] = rng.integers(-2 ** 31, 2 ** 31,
                                          sw.shape[1] - cnt[b])
    return bin_res, cnt, sw, H, W, Wout, s, sc


RES_EDGES = [("ragged", 3, 4), ("ragged", 4, 2), ("ragged", 2, 2),
             ("empty_bands", 2, 4), ("empty_bands", 5, 2),
             ("all_zero", 3, 4), ("all_zero", 2, 2),
             ("garbage", 5, 4), ("garbage", 3, 2)]


@pytest.mark.parametrize("case,lg,OR", RES_EDGES)
def test_residual_stripes_edges_match_jax(case, lg, OR):
    bin_res, cnt, sw, H, W, Wout, s, sc = _residual_edge_case(case, lg, OR)
    n_bands = H // OR
    if case == "all_zero":
        assert cnt.sum() == 0
    want = np.asarray(mp.residual_stripes(
        jnp.asarray(bin_res), jnp.asarray(cnt), jnp.asarray(sw), OR=OR, S=s,
        Wout=Wout, n_bands=n_bands, interpret=True))
    got = mc_seg.residual_stripes(t32(bin_res), t32(cnt), t32(sw), OR=OR,
                                  S=s, Wout=Wout, n_bands=n_bands)
    np.testing.assert_array_equal(got.numpy(), want)
    exp = np.zeros((H, Wout), np.int32)
    for i, x, y in sc[sc[:, 0] >= 0]:
        exp[y:y + s, x:x + s] = bin_res[i]
    np.testing.assert_array_equal(want.reshape(H, Wout), exp)


def _paint_inputs(pus, H, L, rng=None, extra=0):
    """(nseg2 [L, n_bands], sidx2 [n_bands, L, KP], wire PUs) of a PU set;
    `extra` more words a band, random where rng is given."""
    plans = [mc_seg.plan_segment_indices(pus, l, H) for l in range(L)]
    kp = max(p[1].shape[1] for p in plans) + extra
    sidx2 = np.zeros((H // 4, L, kp), np.int32)
    if rng is not None:
        sidx2[:] = rng.integers(0, 1 << 31, sidx2.shape)
    for l, (cnt, sx, _) in enumerate(plans):
        for b in range(H // 4):         # words beyond the count: padding
            w = (int(cnt[b]) + 1) // 2
            sidx2[b, l, :w] = sx[b, :w]
    return np.stack([p[0] for p in plans]), sidx2, mc_seg.pus_to_wire(pus)


@pytest.mark.parametrize("seed,L,W", [(6, 1, 200), (7, 2, 136)])
def test_paint_pu_idx_edges_match_jax(seed, L, W):
    """W4 not a multiple of 32 with PUs at the right edge, bands 4-7 with
    no segment, and random index words beyond each band's count."""
    rng = np.random.default_rng(seed)
    H = 64
    pus = random_pus(rng, H, W, L=L)
    pus = pus[(pus["y"] >= 32) | (pus["y"] + pus["h"] <= 16)]
    assert (pus["x"] + pus["w"] == W).any()
    nseg2, sidx2, puw = _paint_inputs(pus, H, L, rng, extra=2)
    n_bands, W4 = H // 4, W // 4
    assert W4 % 32 and not nseg2[:, 4:8].any()
    want = np.asarray(mp.paint_pu_idx(
        jnp.asarray(nseg2), jnp.asarray(sidx2),
        mp.pack_pu_geo(jnp.asarray(puw)), n_bands=n_bands, W4=W4, L=L,
        interpret=True))
    got = mc_seg.paint_pu_idx(t32(nseg2), t32(sidx2), t32(puw),
                              n_bands=n_bands, W4=W4, L=L)
    np.testing.assert_array_equal(got.numpy(), want)
    exp = np.full((n_bands, W4), -1, np.int32)
    for i, p in enumerate(pus):
        exp[p["y"] // 4:(p["y"] + p["h"]) // 4,
            p["x"] // 4:(p["x"] + p["w"]) // 4] = i
    np.testing.assert_array_equal(want, exp)


def _expand_case(seed, total, B):
    rng = np.random.default_rng(seed)
    nb = (total + B - 1) // B
    keep = np.sort(rng.permutation(nb)[:nb // 3])
    M = len(keep) + 2                      # two padding rows
    blocks = rng.integers(-(1 << 31), 1 << 31, (M, B)).astype(np.int32)
    blocks[len(keep):] = 0
    idx = np.full(M, 1 << 30, np.int32)
    idx[:len(keep)] = keep
    inv = np.full(nb, -1, np.int32)
    inv[keep] = np.arange(len(keep))
    return blocks, idx, inv


@pytest.mark.parametrize("seed,total,B", [(0, 9000, 256), (1, 4096, 128)])
def test_expand_blocks_plain_matches_jax(seed, total, B):
    blocks, idx, inv = _expand_case(seed, total, B)
    want = np.asarray(jfd._expand_blocks_pallas(
        jnp.asarray(blocks), jnp.asarray(inv), total=total, B=B,
        interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jfd._expand_blocks(jnp.asarray(blocks),
                                            jnp.asarray(idx), total=total,
                                            B=B)))
    got = expand.expand_blocks(t32(blocks), t32(inv), total=total, B=B)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        expand._expand_blocks(t32(blocks), t32(idx), total=total,
                              B=B).numpy(), want)


@pytest.mark.parametrize("stream", ["b-tmvp", "tiles"])
def test_host_helpers_match_jax(native_build, stream):
    """pad_sizes, the constants, pus_to_wire, plan_segment_indices,
    plan_residual_segments and pack_band_segments, on the test GOPs' PUs
    and TUs and on a random partition."""
    assert (mc_seg.PADL, mc_seg.PADR, mc_seg.PADT, mc_seg.FW) == \
        (mp.PADL, mp.PADR, mp.PADT, mp.FW)
    for h, w in ((1088, 1920), (544, 960), (48, 64), (17, 33)):
        assert mc_seg.pad_sizes(h, w) == mp.pad_sizes(h, w)
    _, progs = programs(gop_bytes(stream))
    pus_sets = [(p.pus, p.height) for p in progs if len(p.pus)]
    pus_sets.append((random_pus(np.random.default_rng(9), 64, 128, L=2), 64))
    assert len(pus_sets) > 1
    for pus, H in pus_sets:
        for slot_map in (None, {0: 5, 1: 16, 2: 9}):
            np.testing.assert_array_equal(mc_seg.pus_to_wire(pus, slot_map),
                                          mp.pus_to_wire(pus, slot_map))
        for l in (0, 1):
            for a, b in zip(mc_seg.plan_segment_indices(pus, l, H),
                            mp.plan_segment_indices(pus, l, H)):
                np.testing.assert_array_equal(a, b)
    n = 0
    for p in progs:
        bins, _, _ = tfd.fdp._bin_tus(p)
        for lg, b in bins.items():
            for ch, OR in (("y", 4), ("cb", 2), ("cr", 2)):
                got = mc_seg.plan_residual_segments(b[f"sc_{ch}"], 1 << lg,
                                                    OR)
                want = mp.plan_residual_segments(b[f"sc_{ch}"], 1 << lg, OR)
                for a, c in zip(got, want):
                    np.testing.assert_array_equal(a, c)
                nbands = (p.height + 3) // 4
                for a, c in zip(mc_seg.pack_band_segments(*got, nbands),
                                mp.pack_band_segments(*want, nbands)):
                    np.testing.assert_array_equal(a, c)
                n += len(got[0])
    assert n > 0


@pytest.mark.parametrize("fill", [0.05, 0.5, 1.0])
def test_compact_blocks_native_matches_numpy(fill):
    """The native block compaction of the sparse upload against its numpy
    form (the JAX package's _sparse_upload fallback)."""
    rng = np.random.default_rng(int(fill * 100))
    B, nb = 64, 700
    buf = np.zeros(nb * B - 17, np.int32)
    for b in np.flatnonzero(rng.random(nb) < fill):
        buf[b * B + int(rng.integers(0, B)) if b < nb - 1 else -1] = \
            int(rng.integers(1, 1000))
    out_n = np.full((nb, B), 99, np.int32)
    out_p = np.full((nb, B), 99, np.int32)
    M_n, ix_n = tfd.compact_blocks(buf, B, out_n)
    M_p, ix_p = tfd.compact_blocks_plain(buf, B, out_p)
    if M_p > nb:                    # does not fit: both say so
        assert M_n > nb
        return
    assert M_n == M_p
    np.testing.assert_array_equal(ix_n, ix_p)
    np.testing.assert_array_equal(out_n[:M_n], out_p[:M_p])


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

def _same(kernel, plain, counter, *args, **kw):
    n0 = counter()
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert counter() == n0 + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,chroma,bd", ALL_MC)
def test_mc_stripes_kernel_matches_plain(cuda, seed, chroma, bd):  # noqa: F811
    rng = np.random.default_rng(seed)
    H, W = 64, 192
    pus = random_pus(rng, H, W, L=2, max_mv=80, n_slots=17)
    Hd, Wd = (H // 2, W // 2) if chroma else (H, W)
    refs = rng.integers(0, 1 << bd, (17, Hd, Wd)).astype(np.int32)
    hp, wp = mc_seg.pad_sizes(Hd, Wd)
    ring = torch.cat([tfd.pad_replicate(t32(r, cuda), hp, wp) for r in refs])
    for l in (0, 1):
        counts, sidx, K = mc_seg.plan_segment_indices(pus, l, H)
        _same(mc_seg.mc_stripes, mc_seg.mc_stripes_plain,
              lambda: mc_seg.mc_launches, ring, t32(counts, cuda),
              t32(sidx, cuda), t32(mc_seg.pus_to_wire(pus), cuda),
              list_idx=l, OR=2 if chroma else 4, T=4 if chroma else 8,
              Hpad=hp, Wout=256, n_bands=H // 4, KMAX=K, bd=bd,
              chroma=chroma, Hdim=Hd, Wdim=Wd)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 2])
def test_paint_pu_idx_kernel_matches_plain(cuda, L):  # noqa: F811
    rng = np.random.default_rng(L)
    H, W = 64, 192
    nseg2, sidx2, puw = _paint_inputs(random_pus(rng, H, W, L=L), H, L)
    _same(mc_seg.paint_pu_idx, mc_seg.paint_pu_idx_plain,
          lambda: mc_seg.paint_launches, t32(nseg2, cuda), t32(sidx2, cuda),
          t32(puw, cuda), n_bands=H // 4, W4=W // 4, L=L)


@pytest.mark.gpu
@pytest.mark.parametrize("lg,OR", [(2, 4), (5, 4), (2, 2), (5, 2)])
def test_residual_stripes_kernel_matches_plain(cuda, lg, OR):  # noqa: F811
    bin_res, cnt, sw, H, W, s, _ = _residual_case(lg, OR)
    _same(mc_seg.residual_stripes, mc_seg.residual_stripes_plain,
          lambda: mc_seg.residual_launches, t32(bin_res, cuda),
          t32(cnt, cuda), t32(sw, cuda), OR=OR, S=s, Wout=256,
          n_bands=H // OR)


@pytest.mark.gpu
def test_expand_blocks_kernel_matches_plain(cuda):  # noqa: F811
    blocks, _, inv = _expand_case(2, 100000, 1024)
    _same(expand.expand_blocks, expand.expand_blocks_plain,
          lambda: expand.launches, t32(blocks, cuda), t32(inv, cuda),
          total=100000, B=1024)


def _residual_1080p(rng, lg, OR, case):
    """B5 inputs at the 1080p shapes (272 bands; Wout 1920 luma, 1024
    chroma): about a third of the s-grid covered ("tus", with two random
    words beyond each band's count), no segment ("all_zero"), or a bin
    whose word table has no column at all ("k0")."""
    s, n_bands = 1 << lg, 272
    Hc, Wc = (1088, 1920) if OR == 4 else (544, 960)
    gy, gx = Hc // s, Wc // s
    cells = np.flatnonzero(rng.random(gy * gx) < 0.35) \
        if case == "tus" else np.zeros(0, np.int64)
    rng.shuffle(cells)
    n = len(cells)
    sc = np.stack([np.arange(n), (cells % gx) * s, (cells // gx) * s],
                  axis=1).astype(np.int32)
    band, srow, x0 = mc_seg.plan_residual_segments(sc, s, OR)
    cnt, sw, _ = mc_seg.pack_band_segments(band, srow, x0, n_bands)
    if case == "tus":
        sw = np.concatenate([sw, rng.integers(-2 ** 31, 2 ** 31,
                                              (n_bands, 2))], 1)
    elif case == "k0":
        sw = np.zeros((n_bands, 0), np.int32)
    res = rng.integers(-512, 512, (n + 7, s, s))
    return res, cnt, sw, s, (Wc + 127) & ~127, n_bands


RES_1080P = [(lg, OR, "tus") for lg in (2, 3, 4, 5) for OR in (4, 2)] + \
    [(3, 4, "all_zero"), (2, 2, "all_zero"), (4, 4, "k0"), (2, 2, "k0")]


@pytest.mark.gpu
@pytest.mark.parametrize("lg,OR,case", RES_1080P)
def test_residual_stripes_kernel_1080p(cuda, lg, OR, case):  # noqa: F811
    """The kernel writes every lane (its output is not filled first): it
    equals the plain version on two calls into freshly allocated memory,
    the first after the cache was dirtied, and each call counts one
    launch."""
    rng = np.random.default_rng(lg * 10 + OR)
    res, cnt, sw, s, wout, n_bands = _residual_1080p(rng, lg, OR, case)
    args = (t32(res, cuda), t32(cnt, cuda), t32(sw, cuda))
    kw = dict(OR=OR, S=s, Wout=wout, n_bands=n_bands)
    for _ in range(2):
        torch.full((n_bands * OR * wout,), -7, dtype=torch.int32,
                   device=cuda)      # freed: the next output lands on it
        _same(mc_seg.residual_stripes, mc_seg.residual_stripes_plain,
              lambda: mc_seg.residual_launches, *args, **kw)


@pytest.mark.gpu
def test_residual_stripes_rejects_wout_not_multiple_of_4(cuda):  # noqa: F811
    """The kernel stores four lanes at a time: a stripe width that is not
    a multiple of 4 (the feed's is one of 128) raises, launching nothing."""
    res = torch.zeros((1, 4, 4), dtype=torch.int32, device=cuda)
    n0 = mc_seg.residual_launches
    with pytest.raises(ValueError):
        mc_seg.residual_stripes(
            res, torch.zeros(2, dtype=torch.int32, device=cuda),
            torch.zeros((2, 1), dtype=torch.int32, device=cuda), OR=4, S=4,
            Wout=1002, n_bands=2)
    assert mc_seg.residual_launches == n0


def _overlapping_pus(rng, H, W, n, L):
    """n random PU rectangles that overlap on purpose, a few reaching past
    the right edge of the picture."""
    pus = np.zeros(n, PU_DTYPE)
    pus["w"] = 4 * rng.integers(1, 17, n)
    pus["h"] = 4 * rng.integers(1, 5, n)
    pus["x"] = 4 * rng.integers(0, W // 4, n)
    pus["y"] = 4 * rng.integers(0, (H - pus["h"]) // 4 + 1)
    pus["pred_flags"] = rng.integers(1, 4, n) if L == 2 else 1
    return pus


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 2])
def test_paint_pu_idx_kernel_overlap(cuda, L):  # noqa: F811
    """Overlapping segments: the last one that covers a cell wins (list 0
    in order, then list 1), as in the plain version; checked against a
    host raster too."""
    rng = np.random.default_rng(10 + L)
    H, W = 64, 200
    pus = _overlapping_pus(rng, H, W, 120, L)
    nseg2, sidx2, puw = _paint_inputs(pus, H, L)
    kw = dict(n_bands=H // 4, W4=W // 4, L=L)
    args = (t32(nseg2, cuda), t32(sidx2, cuda), t32(puw, cuda))
    for _ in range(2):
        _same(mc_seg.paint_pu_idx, mc_seg.paint_pu_idx_plain,
              lambda: mc_seg.paint_launches, *args, **kw)
    exp = np.full((H // 4, W // 4), -1, np.int32)
    for l in range(L):
        for b in range(H // 4):
            for k in range(nseg2[l, b]):
                i = (sidx2[b, l, k >> 1] >> (16 * (k & 1))) & 0xFFFF
                exp[b, pus["x"][i] // 4:(pus["x"][i] + pus["w"][i]) // 4] = i
    np.testing.assert_array_equal(
        mc_seg.paint_pu_idx(*args, **kw).cpu().numpy(), exp)
