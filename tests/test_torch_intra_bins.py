"""The intra scan's records of a picture: intra_cuda.intra_bins (one memset
and one launch of tde_intra_bins on the card) and the host depth of each
(plane, size) bin from word 0 of the picture's own wire records
(feed.record_depths).

CPU: record_depths over the packer's count of records equals the depths
found a bin at a time over the feed's whole record capacity (the records
unpacked, masked by plane and size), on every picture of the test GOPs and
of RD-split all-intra pictures of the b1080_ai configuration at 256x128,
both packers, pictures without intra records among them; the plain
version of intra_bins equals a record-by-record reference on synthetic
records of every kind that is dropped, with a full bin; the decoder runs
the intra section only for pictures with intra records.

Card (`gpu`): the kernel against the plain version bit for bit, one launch
a call, its arena allocated from poisoned memory, on the feeds of a 1080p
I picture, the RD-split pictures, the 104x72 two-size stream, a 4:2:2 and
a 4:4:4 stream and both CCP streams, and on the synthetic records and
none; a CPU-decoded stream on the card with one launch a picture that has
intra records and none for the others; the wrapper's rejections.  No JAX
here.
"""
import json
import sys

import numpy as np
import pytest
import torch

from libde265_tpu_torch import Encoder, FusedDecoder
from libde265_tpu_torch import fused_decode as tfd
from libde265_tpu_torch.feed import (IREC_COLS, MAX_REFS, WAVE_CAP,
                                     FeedPacker, _pack_irec, bin_depths,
                                     has_ccp, native_live, record_depths)
from libde265_tpu_torch.ops import intra_cuda

from _torch_common import (  # noqa: F401
    CORPUS, GOPS, REPO, cuda, gop_bytes, poison, programs)

sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "gpubench"))
import chip_smoke  # noqa: E402  (the card's 1080p and CCP streams)
from gbench.content import Scene  # noqa: E402


def ai_rd_stream(w=256, h=128, n=2):
    """n pictures of the b1080_ai configuration (RD split, CUs 8 to 64, TUs
    4 to 32, every picture intra) at w x h: scene content_seed + k as in
    the benchmark's clip."""
    cfg = json.loads((REPO / "gpubench" / "configs" /
                      "b1080_ai.json").read_text())
    params = dict(cfg["encoder"])
    with Encoder(qp=params.pop("qp"), ctb_size=params.pop("ctb-size")) as enc:
        params.pop("fps")
        for k, v in params.items():
            enc.set_parameter(k, v)
        data = b"".join(
            enc.encode(*Scene(cfg["content_seed"] + k, h, w, 1,
                              cfg["content"]).frame(0)) for k in range(n))
        return data + enc.finish()


def feed_calls(progs, native=True):
    """Pack each picture as FusedDecoder does on the card (the production
    feed: pack_native while the picture has a live native source and no
    CCP is latched, else pack; native=False: always pack): per picture
    (the intra_bins arguments of the picture program (irecp, bins, scap,
    depths, n), the depths found a bin at a time over the whole capacity,
    len(prog.intras))."""
    pk = FeedPacker()
    pk.plan_stream(progs, pallas_mc=True)
    out = []
    for prog in progs:
        pk.note_rext(prog)
        slot_map = {i: i for i in range(min(len(prog.ref_pocs), MAX_REFS))}
        slot_row = np.zeros(3, np.int32)
        if native and not pk.has_ccp and native_live(prog):
            layout, buf, _, _ = pk.pack_native(prog, slot_map, slot_row)
        else:
            layout, buf, _, _ = pk.pack(prog, slot_map, slot_row,
                                        pallas_mc=True)
        (off, shp), = [(o, s) for k, o, s in layout if k == "irecp"]
        irecp = buf[off:off + 8 * shp[1]].reshape(shp)
        n = pk.last_intra
        u = intra_cuda.unpack_records(irecp)      # the whole capacity
        masked = np.zeros((4, 8), np.int64)
        for c in range(3):
            for lg in (2, 3, 4, 5):
                hs = (u[:, 8] == c) & (u[:, 9] == lg)
                masked[c, lg] = int((u[hs, 6] + 1).max(initial=0))
        args = (irecp, tuple(sorted(pk.intra_lgs)), pk.caps["steps"] or 1,
                record_depths(irecp[0, :n]), n)
        out.append((args, masked, len(prog.intras)))
    return out


def stream_bytes(name, tmp=None):
    if name in GOPS:
        return gop_bytes(name)
    if name == "ai-rd":
        return ai_rd_stream()
    if name == "1080p-I":
        return chip_smoke.make_stream(tmp / "1080p_I.h265", 1920, 1088, 1,
                                      32, {"intra-period": 1,
                                           "sao": True})[0]
    if name.startswith("ccp-"):
        return chip_smoke.make_ccp_stream(tmp / f"{name}.h265",
                                          name == "ccp-lossless")
    return (CORPUS / f"{name}.h265").read_bytes()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", list(GOPS) + ["ai-rd"])
def test_record_depths_match_masked_bins(native_build, name, native):
    """record_depths over the packer's count of records (word 0 alone)
    gives every bin's depth as the mask a bin over the unpacked capacity
    does; the count is the picture's intra blocks."""
    calls = feed_calls(programs(stream_bytes(name))[1], native)
    for i, ((irecp, _, _, depths, n), masked, n_prog) in enumerate(calls):
        assert n == n_prog, f"picture {i}"
        np.testing.assert_array_equal(depths, masked, err_msg=f"picture {i}")
        assert (depths > 0).any() == (n > 0)
    counts = [c[2] for c in calls]
    assert all(counts) if "intra" in name or name == "ai-rd" else \
        0 in counts and any(counts)


def test_bin_depths_of_no_records():
    empty = np.zeros(0, np.int32)
    assert not bin_depths(empty, empty, empty).any()
    assert not record_depths(np.zeros(16, np.int32)[:0]).any()


def synthetic_records(seed, scap=12):
    """Wire records [8, cap] (cap > n: zero padding after them), n, the
    bins, scap and the reference arrays of every bin, built record by
    record: records in three bins with distinct random (step, slot),
    step 0 of the luma 4x4 bin full (K records), and records that are
    dropped: of a bin not among the bins, with step scap and 8191, with
    slot K and 1023."""
    rng = np.random.default_rng(seed)
    bins = (("y", 2), ("cb", 3), ("cr", 5))
    recs = []

    def rec(c, lg, step, slot):
        r = np.zeros(IREC_COLS, np.int64)
        r[0], r[1], r[4] = rng.integers(0, 64), rng.integers(0, 16), \
            rng.integers(0, 16)
        r[2], r[3] = rng.integers(0, 1 << 16, 2)
        r[5] = rng.integers(-1, (1 << 22) - 1)
        r[6], r[7], r[8], r[9] = step, slot, c, lg
        r[10:] = rng.integers(-(1 << 31), 1 << 31, 5)
        recs.append(r)

    for slot in range(WAVE_CAP[2]):
        rec(0, 2, 0, slot)
    for pc, lg in bins:
        c, K = intra_cuda.PLANE_OF[pc], WAVE_CAP[lg]
        cells = rng.choice(scap * K, size=min(40, scap * K), replace=False)
        for e in cells:
            if pc != "y" or e >= K:
                rec(c, lg, e // K, e % K)
    rec(1, 5, 3, 0)                              # a bin not among the bins
    rec(0, 2, scap, 5)
    rec(2, 5, 8191, 1)                           # steps past scap
    rec(1, 3, 2, WAVE_CAP[3])
    rec(2, 5, 1, 1023)                           # slots past K
    order = rng.permutation(len(recs))           # parse order, not slots
    irec = np.array(recs, np.int64)[order].astype(np.int32)
    n = len(irec)
    irecp = np.zeros((8, n + 37), np.int32)
    irecp[:, :n] = _pack_irec(irec)
    want = {}
    for pc, lg in bins:
        c, K = intra_cuda.PLANE_OF[pc], WAVE_CAP[lg]
        v = {"meta": np.zeros((scap, K, 5), np.int32),
             "rrow": np.full((scap, K), -1, np.int32),
             "aw": np.zeros((scap, K, 5), np.int32)}
        for r in irec:
            if r[8] == c and r[9] == lg and r[6] < scap and r[7] < K:
                v["meta"][r[6], r[7]] = r[0:5]
                v["rrow"][r[6], r[7]] = r[5]
                v["aw"][r[6], r[7]] = r[10:15]
        want.setdefault(c, {})[lg] = v
    depths = bin_depths(irec[:, 8], irec[:, 9], irec[:, 6])
    return irecp, n, bins, scap, depths, want


def assert_bins_equal(got, want, what):
    assert got.keys() == want.keys(), what
    for c in want:
        assert got[c].keys() == want[c].keys(), what
        for lg, v in want[c].items():
            for k, a in v.items():
                b = got[c][lg][k]
                if torch.is_tensor(b):
                    b = b.cpu().numpy()
                if torch.is_tensor(a):
                    a = a.cpu().numpy()
                assert np.shape(a) == np.shape(b), (what, c, lg, k)
                assert np.array_equal(a, b), (what, c, lg, k)


@pytest.mark.parametrize("seed", [0, 1])
def test_intra_bins_plain_matches_reference(seed):
    """The plain version (unpack, then three index_put_ a bin) against the
    record-by-record reference: every drop kind dropped, the full step
    kept, unused slots 0 and -1, depths as given."""
    irecp, n, bins, scap, depths, want = synthetic_records(seed)
    got = intra_cuda.intra_bins(torch.from_numpy(irecp), bins, scap, depths,
                                n)
    assert_bins_equal(got, want, "plain")
    for c, by_lg in got.items():
        for lg, v in by_lg.items():
            assert v["depth"] == depths[c, lg] > 0
    u = intra_cuda.unpack_records(irecp[:, :n])
    full = (u[:, 8] == 0) & (u[:, 9] == 2) & (u[:, 6] == 0)
    assert full.sum() == WAVE_CAP[2]
    assert sorted(u[full, 7]) == list(range(WAVE_CAP[2]))
    # the flat records scattered, as the tests and chip_smoke call it
    irec = intra_cuda.unpack_records(irecp[:, :n])
    assert_bins_equal(intra_cuda.scatter_records(
        torch.from_numpy(irec), bins, scap,
        bin_depths(irec[:, 8], irec[:, 9], irec[:, 6])), want, "flat")


@pytest.mark.parametrize("bins", [(("y", 2),),
                                  (("cb", 3), ("y", 5), ("cr", 2)),
                                  tuple((pc, lg) for pc in ("y", "cb", "cr")
                                        for lg in (2, 3, 4, 5))])
def test_bin_layout_tiles_the_arena(bins):
    """The kernel's arguments and the parts the wrapper views: every bin's
    meta, aw, then all rrow arrays in one run, back to back, each a
    multiple of 16 bytes, at the offsets the kernel is given; a bad bin,
    a bin named twice or no step raises ValueError."""
    scap = 7
    args, words, sizes, layout = intra_cuda._bin_layout(bins, scap)
    a = intra_cuda._BinArgs.from_buffer_copy(args)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    assert sum(sizes) == words == a.arena_words
    assert all(n % 4 == 0 for n in sizes) and len(sizes) == 3 * len(bins)
    assert a.rrow_at == starts[2 * len(bins)] and \
        a.rrow_words == words - a.rrow_at
    assert (a.scap, a.aw_words) == (scap, intra_cuda.AW_WORDS)
    seen = set()
    for (pc, lg), (c, lg_, shapes, idx) in zip(bins, layout):
        b = 4 * c + lg - 2
        assert (c, lg_) == (intra_cuda.PLANE_OF[pc], lg)
        assert a.K[b] == WAVE_CAP[lg]
        for off, shp, i in zip((a.meta[b], a.rrow[b], a.aw[b]), shapes,
                               idx):
            assert off == starts[i] and np.prod(shp) == sizes[i]
        assert shapes == ((scap, WAVE_CAP[lg], 5), (scap, WAVE_CAP[lg]),
                          (scap, WAVE_CAP[lg], intra_cuda.AW_WORDS))
        seen.add(b)
    assert [a.K[b] > 0 for b in range(12)] == [b in seen for b in range(12)]
    for bad, s in ((bins + (("u", 2),), scap), (bins + (("y", 6),), scap),
                   (bins + bins[:1], scap), (bins, 0)):
        with pytest.raises(ValueError):
            intra_cuda._bin_layout(bad, s)


@pytest.mark.parametrize("stream", ["p-sao", "tiles"])
def test_intra_section_only_with_records(native_build, monkeypatch, stream):
    """The production program on the CPU: intra_bins and the scan run for
    each picture with intra records and for no other; the pictures equal
    the oracle."""
    _, progs = programs(gop_bytes(stream))
    seen = {"bins": 0, "scan": 0}
    bins_fn, scan_fn = intra_cuda.intra_bins, tfd._intra_scan_all

    def count(key, fn):
        def run(*a, **k):
            seen[key] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(intra_cuda, "intra_bins", count("bins", bins_fn))
    monkeypatch.setattr(tfd, "_intra_scan_all", count("scan", scan_fn))
    fd = FusedDecoder(device="cpu")
    fd.use_pallas_mc = True
    fd.plan_stream(progs)
    for i, prog in enumerate(progs):
        for c, pl in enumerate(fd.decode(prog)):
            np.testing.assert_array_equal(pl.numpy(), prog.planes[c],
                                          err_msg=f"picture {i} plane {c}")
    with_records = sum(len(p.intras) > 0 for p in progs)
    assert 0 < with_records < len(progs)
    assert seen == {"bins": with_records, "scan": with_records}


# ---------------------------------------------------------------------------
# the kernel against its plain version (skip without a card)
# ---------------------------------------------------------------------------

def _arena_words(bins, scap):
    return scap * sum(WAVE_CAP[lg] for _, lg in bins) * 11


def check_kernel(dev, irecp, bins, scap, depths, n, want=None):
    """intra_bins on the card, its arena allocated from poisoned memory,
    against the plain version on the CPU, bit for bit, one launch a call
    (twice)."""
    want = want or intra_cuda.intra_bins(torch.from_numpy(irecp), bins,
                                         scap, depths, n)
    d = torch.from_numpy(irecp).to(dev)
    for _ in range(2):
        poison(_arena_words(bins, scap))
        before = intra_cuda.bin_launches
        got = intra_cuda.intra_bins(d, bins, scap, depths, n)
        assert intra_cuda.bin_launches == before + 1
        torch.cuda.synchronize()
        assert_bins_equal(got, want, "kernel")
        for c, by_lg in got.items():
            for lg, v in by_lg.items():
                assert v["depth"] == depths[c, lg]
                assert all(t.data_ptr() % 16 == 0 for t in
                           (v["meta"], v["rrow"], v["aw"]))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["1080p-I", "ai-rd", "conf_window_104x72",
                                  "chroma422", "main10_444", "ccp-lossless",
                                  "ccp-lossy"])
def test_intra_bins_kernel_captured(cuda, native_build, tmp_path, name):
    """Every picture's call of the decode on the card, from the packer's
    feed of a stream, against the plain version."""
    progs = programs(stream_bytes(name, tmp_path))[1]
    if name.startswith("ccp-"):
        assert any(has_ccp(p) for p in progs)
    calls = feed_calls(progs)
    assert any(c[2] for c in calls)
    for args, _, n in calls:
        if n:
            check_kernel(cuda, *args)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_intra_bins_kernel_synthetic(cuda, seed):
    """Every drop kind, a full step, zero padding after the records; also
    with the padding read (n = the capacity) and with no record read."""
    irecp, n, bins, scap, depths, want = synthetic_records(seed)
    check_kernel(cuda, irecp, bins, scap, depths, n, want)
    check_kernel(cuda, irecp, bins, scap, depths, irecp.shape[1], want)
    check_kernel(cuda, irecp, bins, scap, np.zeros((4, 8), np.int64), 0)


@pytest.mark.gpu
def test_intra_bins_decode_on_card(cuda, native_build):
    """FusedDecoder() on the card: one intra_bins launch and one scan a
    picture with intra records, none for the others; every picture equal
    to the oracle."""
    _, progs = programs(gop_bytes("p-sao"))
    fd = FusedDecoder(device=cuda)
    fd.plan_stream(progs)
    for i, prog in enumerate(progs):
        before = (intra_cuda.bin_launches, intra_cuda.scan_launches)
        planes = fd.decode(prog)
        torch.cuda.synchronize()
        k = int(len(prog.intras) > 0)
        assert (intra_cuda.bin_launches, intra_cuda.scan_launches) == (
            before[0] + k, before[1] + k), f"picture {i}"
        for c, pl in enumerate(planes):
            np.testing.assert_array_equal(pl.cpu().numpy(), prog.planes[c],
                                          err_msg=f"picture {i} plane {c}")


@pytest.mark.gpu
def test_intra_bins_rejects_bad_inputs(cuda):
    """A wrong dtype raises TypeError; records that are not [8, >= n] and
    contiguous on the card, a count outside them, a plane class or size
    with no bin, a bin named twice and no step raise ValueError (there is
    no fallback)."""
    irecp, n, bins, scap, depths, _ = synthetic_records(0)
    d = torch.from_numpy(irecp).to(cuda)

    def call(rec=d, b=bins, s=scap, k=n):
        return intra_cuda.intra_bins(rec, b, s, depths, k)

    call()
    with pytest.raises(TypeError):
        call(rec=d.to(torch.int64))
    with pytest.raises(ValueError):
        call(rec=d[:7].contiguous())
    with pytest.raises(ValueError):
        call(rec=d.reshape(-1))
    with pytest.raises(ValueError):
        call(rec=d.t().contiguous().t())
    for k in (-1, d.shape[1] + 1):
        with pytest.raises(ValueError):
            call(k=k)
    for b in (bins + (("u", 2),), bins + (("y", 6),), bins + bins[:1]):
        with pytest.raises(ValueError):
            call(b=b)
    with pytest.raises(ValueError):
        call(s=0)
