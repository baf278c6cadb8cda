"""Shared helpers of the libde265_tpu_torch tests (not a test module).

Streams come from the in-repo encoder, as in tests/test_fused_decode.py;
random inputs come from numpy with fixed seeds so that the JAX reference
and the PyTorch port see identical data.

Importing this module builds the whole native tree under the port's build
lock, then the stream corpus (``ensure_corpus``).  Every port test module
imports it while pytest collects, and under xdist every worker collects
before any test runs, so the workers queue on the locks, one builds, and
the native_build fixture's ninja and the corpus tests later find nothing
to do.
"""
import fcntl
import functools
import os
import shutil
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from libde265_tpu import Decoder, Encoder
from libde265_tpu_torch import _native

REPO = Path(__file__).resolve().parent.parent
OWN_CORPUS = REPO / "build" / "tde_corpus"   # tests/test_torch_corpus.py
CORPUS = Path("/tmp/tde_corpus")   # fixed by tests/test_native_pack.py


@contextmanager
def _locked(path: Path):
    with open(path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _publish(src: Path, dst: Path, wait_s: float = 60.0):
    """A complete copy of src at dst, unless dst holds a complete corpus.

    The copy is made in a private directory beside dst and renamed to dst,
    so no process sees it half written.  Our processes do this under a
    lock beside dst.  A dst without its manifest is being written by a
    process that does not take the lock (an older checkout's
    test_corpus_sweep builds there in place): it gets wait_s to finish,
    after which it counts as the remains of a killed build and is set
    aside."""
    with _locked(dst.with_name(dst.name + ".lock")):
        deadline = time.monotonic() + wait_s
        while (dst.exists() and not (dst / "manifest.json").exists() and
               time.monotonic() < deadline):
            time.sleep(0.5)
        if (dst / "manifest.json").exists():
            return
        if dst.exists():
            stale = Path(tempfile.mkdtemp(dir=dst.parent,
                                          prefix=dst.name + ".stale."))
            try:
                os.rename(dst, stale / "corpus")
            except FileNotFoundError:
                pass
            shutil.rmtree(stale, ignore_errors=True)
        tmp = Path(tempfile.mkdtemp(dir=dst.parent, prefix=dst.name + "."))
        try:
            shutil.copytree(src, tmp, dirs_exist_ok=True)
            tmp.chmod(0o755)
            os.rename(tmp, dst)
        except OSError:
            pass    # dst appeared meanwhile: its writer completes it
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def ensure_corpus() -> Path:
    """Make the stream corpus of scripts/make_corpus.py once per checkout,
    and put a copy where tests/test_native_pack.py reads it.

    tests/test_native_pack.py and tests/test_torch_corpus.py read it, and
    only tests/test_corpus_sweep.py used to make it, so under xdist with
    --dist loadfile their cases skipped or passed by which file ran first.
    This is the one test helper shared with the older tests that the port
    may change, so the corpus is made here, at import: under the checkout's
    build directory (OWN_CORPUS, built in a private directory and renamed
    into place under a lock, so every worker waits while one builds), then
    copied whole to /tmp/tde_corpus, the path that test_native_pack.py and
    test_corpus_sweep.py fix and that other checkouts on the machine share
    (_publish).  Returns OWN_CORPUS."""
    build = OWN_CORPUS.parent
    build.mkdir(parents=True, exist_ok=True)
    with _locked(build / ".corpus.lock"):
        if not (OWN_CORPUS / "manifest.json").exists():
            shutil.rmtree(OWN_CORPUS, ignore_errors=True)
            sys.path.insert(0, str(REPO / "scripts"))
            import make_corpus
            tmp = Path(tempfile.mkdtemp(dir=build, prefix=".tde_corpus."))
            try:
                make_corpus.build(tmp)
                os.rename(tmp, OWN_CORPUS)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    _publish(OWN_CORPUS, CORPUS)
    return OWN_CORPUS


_native.build_tree()
ensure_corpus()

# The port's CPU tests run small tensors, on which torch's intra-op threads
# mostly wait: one thread runs tests/test_torch_corpus.py in 43 s where
# eight take 58 s and seven times the CPU time on an 8-core host, and
# under xdist it leaves the cores to the other workers.
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    """The CUDA device, or skip: the hand-written kernels run only there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def gop(w=96, h=96, n=5, bit_depth=8, **params):
    """A small synthetic GOP (bytes), cached per parameter set."""
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    sc = 1 << (bit_depth - 8)
    dt = np.uint16 if bit_depth > 8 else np.uint8
    with Encoder(qp=30, ctb_size=32, bit_depth=bit_depth) as enc:
        for k, v in params.items():
            enc.set_parameter(k, v)
        stream = b""
        for f in range(n):
            y = (128 + 60 * np.sin((xx + 3 * f) * 0.11)
                 * np.cos((yy + 2 * f) * 0.07)).clip(0, 255)
            cb = (100 + 40 * np.sin((xx[::2, ::2] + f) * 0.07)).clip(0, 255)
            cr = (150 - 40 * np.cos((yy[::2, ::2] + f) * 0.06)).clip(0, 255)
            stream += enc.encode((y * sc).astype(dt), (cb * sc).astype(dt),
                                 (cr * sc).astype(dt))
        return stream + enc.finish()


GOPS = {
    "p-sao": dict(params=(("intra-period", 8), ("sao", True))),
    "b-tmvp": dict(params=(("intra-period", 8), ("b-slices", True),
                           ("tmvp", True))),
    "2refs": dict(params=(("intra-period", 8), ("num-refs", 2))),
    "weighted": dict(params=(("intra-period", 8), ("weighted-pred", True))),
    "all-intra": dict(w=64, h=64, n=3, params=(("intra-period", 1),
                                                ("sao", True))),
    "10bit": dict(w=64, h=48, bit_depth=10,
                  params=(("intra-period", 4), ("sao", True))),
    "tiles": dict(w=128, h=96, params=(("intra-period", 4), ("sao", True),
                                       ("tile-cols", 2), ("tile-rows", 2),
                                       ("across-tiles", False),
                                       ("ctbs-per-slice", 3))),
}


@functools.lru_cache(maxsize=None)
def stripe_stream(w=256, h=64, n=12, qp=30, ctb=32, block=8, seed=7):
    """A stream whose pictures read many references (bytes, cached): 16
    vertical stripes, stripe j showing one of j + 1 textures of random
    block levels (block x block luma samples a level) in turn, so that it
    repeats every j + 1 pictures and picture t finds an exact match for
    stripe j in picture t - j - 1 only.  Encoded with up to 15 references
    and intra period 32, picture t reads min(t, 15) of them."""
    sw = w // 16
    rng = np.random.default_rng(seed)
    tex = [[[rng.integers(16, 236, (h // block + 1, sw // block + 1))
             for _ in range(j + 1)] for j in range(16)] for _ in range(2)]
    one = np.ones((block, block))
    with Encoder(qp=qp, ctb_size=ctb) as enc:
        enc.set_parameter("num-refs", 15)
        enc.set_parameter("intra-period", 32)
        enc.set_parameter("sao", True)
        stream = b""
        for t in range(n):
            y = np.zeros((h, w), np.uint8)
            cb = np.zeros((h // 2, w // 2), np.uint8)
            for j in range(16):
                k = t % (j + 1)
                y[:, j * sw:(j + 1) * sw] = np.kron(tex[0][j][k], one)[
                    :h, :sw]
                cb[:, j * sw // 2:(j + 1) * sw // 2] = np.kron(
                    tex[1][j][k], one[::2, ::2])[:h // 2, :sw // 2]
            stream += enc.encode(y, cb, 255 - cb)
        return stream + enc.finish()


def _nal_units(data):
    """[(start, end)] of the NAL unit payloads of an Annex B byte stream
    (after each 00 00 01 start code)."""
    starts, i = [], data.find(b"\x00\x00\x01")
    while i >= 0:
        starts.append(i + 3)
        i = data.find(b"\x00\x00\x01", i + 3)
    ends = [s - 3 for s in starts[1:]] + [len(data)]
    # a 4-byte start code leaves a zero byte at the end of the previous unit
    return [(s, e - 1 if e < len(data) and data[e - 1] == 0 else e)
            for s, e in zip(starts, ends)]


def _rbsp_bits(ebsp):
    """The bits of an RBSP from its escaped bytes (emulation prevention
    removed), as a list of 0/1."""
    out, zeros = bytearray(), 0
    for b in ebsp:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return [(b >> (7 - k)) & 1 for b in out for k in range(8)]


def _escape(bits):
    """Bytes of an RBSP with its stop bit and alignment added, escaped with
    emulation prevention bytes."""
    bits = bits + [1] + [0] * (-(len(bits) + 1) % 8)
    raw = bytes(int("".join(map(str, bits[i:i + 8])), 2)
                for i in range(0, len(bits), 8))
    out, zeros = bytearray(), 0
    for b in raw:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _ue(v):
    """Exp-Golomb bits of v."""
    code = bin(v + 1)[2:]
    return [0] * (len(code) - 1) + [int(c) for c in code]


def with_chroma_depth(data, bit_depth_chroma=10):
    """The stream with its SPS's bit_depth_chroma_minus8 rewritten (the SPS
    RBSP re-emitted with emulation prevention), every other bit kept.

    For a stream without PCM, extended precision, high-precision offsets
    or a chroma SAO offset of magnitude 7 (sao_offset_abs's largest value
    at 8 bits, which ends its binarization there), no slice syntax depends
    on the chroma depth, so the native decoder parses the same syntax at
    the new depth and reconstructs the chroma planes at it: its planes are
    the oracle of a stream with unequal depths (ROADMAP C8)."""
    out, pos = bytearray(), 0
    for s, e in _nal_units(data):
        if (data[s] >> 1) & 63 != 33:       # not an SPS
            continue
        bits = _rbsp_bits(data[s + 2:e])
        p = [0]

        def u(n):
            v = 0
            for _ in range(n):
                v = (v << 1) | bits[p[0]]
                p[0] += 1
            return v

        def ue():
            z = 0
            while bits[p[0] + z] == 0:
                z += 1
            p[0] += z
            return u(z + 1) - 1

        u(4)                                # sps_video_parameter_set_id
        if u(3) != 0:                       # sps_max_sub_layers_minus1
            raise ValueError("only one sub-layer is handled")
        u(1)
        u(96)                               # profile_tier_level
        ue()                                # sps_seq_parameter_set_id
        if ue() == 3:                       # chroma_format_idc
            u(1)
        ue(), ue()                          # picture width, height
        if u(1):                            # conformance_window_flag
            for _ in range(4):
                ue()
        ue()                                # bit_depth_luma_minus8
        at = p[0]
        ue()                                # bit_depth_chroma_minus8
        rest = bits[p[0]:]
        rest = rest[:len(rest) - rest[::-1].index(1) - 1]   # stop bit off
        rbsp = bits[:at] + _ue(bit_depth_chroma - 8) + rest
        out += data[pos:s + 2] + _escape(rbsp)
        pos = e
    return bytes(out + data[pos:])


@functools.lru_cache(maxsize=None)
def chroma_depth_gop():
    """A 64x64 B-GOP with SAO and TMVP (5 pictures, bi-predicted PUs in
    three) whose SPS says 8-bit luma and 10-bit chroma
    (with_chroma_depth); no chroma SAO offset of its 8-bit parse has
    magnitude 7."""
    return with_chroma_depth(gop(w=64, h=64, n=5, **CHROMA_DEPTH_GOP))


CHROMA_DEPTH_GOP = {"intra-period": 8, "sao": True, "b-slices": True,
                    "tmvp": True}


@functools.lru_cache(maxsize=None)
def tskip_stream(w=64, h=64, n=3, seed=3):
    """A stream with transform-skip TUs (bytes, cached): flat pictures with
    isolated bright samples (5% of them, seeded), encoded with transform
    skip on, 8x8 CUs (cb-split-algo min-8), so that 4:2:0 chroma TUs
    are 4x4, and intra period 8 (P pictures after the first).  The
    encoder takes transform skip for a 4x4 TU whose levels sum to less
    than the DCT's (native/src/encoder.cc), as an impulse's do."""
    rng = np.random.default_rng(seed)
    with Encoder(qp=30, ctb_size=32) as enc:
        enc.set_parameter("transform-skip", True)
        enc.set_parameter("cb-split-algo", "min-8")
        enc.set_parameter("intra-period", 8)
        stream = b""
        for _ in range(n):
            y = np.full((h, w), 100, np.uint8)
            y[rng.random((h, w)) < 0.05] = 220
            cb = np.full((h // 2, w // 2), 128, np.uint8)
            cb[rng.random((h // 2, w // 2)) < 0.05] = 200
            stream += enc.encode(y, cb, cb.copy())
        return stream + enc.finish()


def gop_bytes(name):
    g = dict(GOPS[name])
    params = dict(g.pop("params"))
    return gop(**g, **params)


def programs(data):
    """(decoder, programs) of a full scalar decode: each program carries
    the oracle's planes."""
    dec = Decoder(keep_programs=True)
    list(dec.decode_all(data))
    return dec, [dec.get_program(i) for i in range(dec.num_programs())]


def encode_csr(pos, val):
    """Byte entries of one TU: sorted positions, values in [-7..7] \\ {0}."""
    order = np.argsort(pos)
    pos, val = np.asarray(pos)[order], np.asarray(val)[order]
    out = []
    p = -1
    for q, v in zip(pos, val):
        g = int(q) - p - 1
        out.extend([0] * (g // 15))
        out.append(((g % 15) & 0xF) | ((int(v) & 0xF) << 4))
        p = int(q)
    while len(out) % 4:
        out.append(0)
    return out


def bytes_to_words(bs):
    b = np.asarray(bs, np.int64)
    if len(b) % 4:
        b = np.concatenate([b, np.zeros(4 - len(b) % 4, np.int64)])
    return (b[0::4] | (b[1::4] << 8) | (b[2::4] << 16) |
            (b[3::4] << 24)).astype(np.uint32).view(np.int32)


def random_csr(rng, N, S, max_nnz, dense_frac=0.1):
    """Random CSR bin: per-TU unique positions, 4-bit signed values, runs
    padded to 4-entry multiples with zero bytes."""
    bs, offs = [], [0]
    for _ in range(N):
        if rng.random() < 0.25:
            n = 0
        elif rng.random() < dense_frac:
            n = min(S * S, max_nnz)
        else:
            n = int(rng.integers(1, min(S * S, max_nnz) + 1))
        pos = rng.permutation(S * S)[:n]
        val = rng.integers(-7, 8, n)
        val[val == 0] = 1
        e = encode_csr(pos, val) if n else []
        bs.extend(e)
        offs.append(offs[-1] + len(e))
    return bytes_to_words(bs), np.array(offs, np.int32)


def poison(n):
    """Fill and free n int32 on the card, so that the caching allocator
    hands the next allocation of that size memory that holds 0x7f7f7f7f."""
    torch.full((n,), 0x7F7F7F7F, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()


def t32(a, device="cpu"):
    """numpy -> int32 (or bool) torch tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype != bool:
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)
