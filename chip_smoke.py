#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (libde265_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises and the script exits non-zero):
  1. card check: a CUDA device must be present; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: the native parser library (cmake + ninja, the library target
     only) and the port's CUDA kernels (nvcc, sm_90a);
  3. main path at 1080p: a 1920x1088 P-GOP stream made by the in-repo
     encoder is decoded with PipelinedDecoder(device="cuda"), every frame
     held bit-exact against the scalar oracle's planes, with each kernel's
     launch counted; prints fps and per-frame milliseconds (I and P);
  4. kernels vs plain: each kernel against its plain PyTorch version on the
     card, on seeded random inputs at the 1080p shapes and on the inputs
     captured from the first I and P picture; exact equality; median
     CUDA-event times of both;
  5. a 416x240 B/weighted/2-ref stream, bit-exact on the card.

The last two lines of stdout are the kernels JSON object and the card's
nvidia-smi line, followed by the result line
{"ok": true, "device": {...}}.  Nothing here imports JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
BUILD = REPO / "build"
sys.path.insert(0, str(REPO))

KERNELS = {
    # family -> (source, TPU kernel it replaces)
    "B4 densify_bin": ("libde265_tpu_torch/csrc/coef.cu",
                       "libde265_tpu/ops/coef_pallas.py:165"),
    "B8 luma_pass (V+H)": ("libde265_tpu_torch/csrc/deblock.cu",
                           "libde265_tpu/ops/deblock_pallas.py:212"),
    "B9 chroma_pass_stacked (V+H)": ("libde265_tpu_torch/csrc/deblock.cu",
                                     "libde265_tpu/ops/deblock_pallas.py:263"),
    "B10 sao_plane_fused": ("libde265_tpu_torch/csrc/sao.cu",
                            "libde265_tpu/ops/sao_pallas.py:120"),
}


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# phase 1 + 2
# ---------------------------------------------------------------------------

def card_check():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script measures the port on a CUDA card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}  (torch {torch.__version__}, CUDA {torch.version.cuda})")
    return smi


def build_native():
    """libtde265.so from native/, built by native/CMakeLists.txt."""
    lib = BUILD / "libtde265.so"
    if lib.exists():
        return 0.0
    BUILD.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run(["cmake", "-G", "Ninja", "-DCMAKE_BUILD_TYPE=Release",
                    str(REPO / "native")], cwd=BUILD, check=True,
                   capture_output=True)
    subprocess.run(["ninja", "libtde265.so"], cwd=BUILD, check=True,
                   capture_output=True)
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def synth_frame(t, base, xx, yy):
    """Moving gradient + fixed texture (the 1080p benchmark content)."""
    y = ((xx + 4 * t) % 255 // 2 + (yy + 2 * t) % 128 + base) % 235
    cb = (xx[::2, ::2] // 2 + 3 * t) % 200 + 20
    cr = (yy[::2, ::2] // 2 + 2 * t) % 200 + 20
    return y.astype(np.uint8), cb.astype(np.uint8), cr.astype(np.uint8)


def make_stream(path: Path, w, h, frames, qp, params):
    """Encode (or reuse) a stream under build/; returns (bytes, seconds)."""
    if path.exists():
        return path.read_bytes(), 0.0
    from libde265_tpu import Encoder
    rng = np.random.default_rng(42)
    base = rng.integers(0, 40, (h, w), np.int16)
    yy, xx = np.mgrid[0:h, 0:w]
    t0 = time.perf_counter()
    with Encoder(qp=qp) as enc:
        for k, v in params.items():
            enc.set_parameter(k, v)
        data = b"".join(enc.encode(*synth_frame(t, base, xx, yy))
                        for t in range(frames)) + enc.finish()
    dt = time.perf_counter() - t0
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return data, dt


def oracle_programs(data):
    """Programs with the scalar decoder's planes (the bit-exact oracle)."""
    from libde265_tpu import Decoder
    dec = Decoder(keep_programs=True)
    list(dec.decode_all(data))
    return dec, [dec.get_program(i) for i in range(dec.num_programs())]


def assert_bit_exact(outs, progs, what):
    if len(outs) != len(progs):
        raise AssertionError(f"{what}: {len(outs)} frames decoded, oracle "
                             f"has {len(progs)}")
    for i, (planes, prog) in enumerate(zip(outs, progs)):
        for c, pl in enumerate(planes):
            got = pl.cpu().numpy()
            want = prog.planes[c].astype(np.int32)
            if not np.array_equal(got, want):
                bad = np.argwhere(got != want)
                raise AssertionError(
                    f"{what}: frame {i} plane {c}: {len(bad)} samples "
                    f"differ, first at {bad[0].tolist()}")


# ---------------------------------------------------------------------------
# launch counters and input capture
# ---------------------------------------------------------------------------

def kernel_modules():
    from libde265_tpu_torch.ops import coef_cuda, deblock_cuda, sao_cuda
    return coef_cuda, deblock_cuda, sao_cuda


def reset_counts():
    coef, dbk, sao = kernel_modules()
    coef.launches = 0
    dbk.luma_launches = 0
    dbk.chroma_launches = 0
    sao.launches = 0


def read_counts():
    coef, dbk, sao = kernel_modules()
    names = list(KERNELS)
    return {names[0]: coef.launches, names[1]: dbk.luma_launches,
            names[2]: dbk.chroma_launches, names[3]: sao.launches}


WRAPPERS = (("coef", "densify_bin"), ("dbk", "luma_pass"),
            ("dbk", "luma_pass_h"), ("dbk", "chroma_pass_stacked"),
            ("dbk", "chroma_pass_stacked_h"), ("sao", "sao_plane_fused"))


def capture_inputs(fd, progs):
    """Decode progs with every kernel wrapper recording (a clone of) its
    arguments; returns {wrapper name: [(args, kwargs), ...]} per picture."""
    import torch
    coef, dbk, sao = kernel_modules()
    mods = {"coef": coef, "dbk": dbk, "sao": sao}
    saved = {}
    per_frame = []

    def wrap(mod, name, fn):
        def rec(*args, **kwargs):
            cl = [a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args]
            kw = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                  for k, v in kwargs.items()}
            per_frame[-1].setdefault(name, []).append((cl, kw))
            return fn(*args, **kwargs)
        return rec

    for m, name in WRAPPERS:
        fn = getattr(mods[m], name)
        saved[(m, name)] = fn
        setattr(mods[m], name, wrap(m, name, fn))
    try:
        for prog in progs:
            per_frame.append({})
            fd.decode(prog)
        torch.cuda.synchronize()
    finally:
        for (m, name), fn in saved.items():
            setattr(mods[m], name, fn)
    return per_frame


# ---------------------------------------------------------------------------
# phase 4: kernels vs plain
# ---------------------------------------------------------------------------

def _csr_bin(rng, N, S):
    """Random valid CSR bin: unique positions per TU, 4-bit values."""
    bs, offs = [], [0]
    for _ in range(N):
        n = 0 if rng.random() < 0.3 else int(rng.integers(1, S * S + 1))
        pos = np.sort(rng.permutation(S * S)[:n])
        val = rng.integers(1, 8, n) * rng.choice([-1, 1], n)
        out, p = [], -1
        for q, v in zip(pos, val):
            g = int(q) - p - 1
            out.extend([0] * (g // 15))
            out.append((g % 15) | ((int(v) & 0xF) << 4))
            p = int(q)
        while len(out) % 4:
            out.append(0)
        bs.extend(out)
        offs.append(offs[-1] + len(out))
    b = np.asarray(bs + [0] * (-len(bs) % 4), np.int64)
    cv = (b[0::4] | (b[1::4] << 8) | (b[2::4] << 16) | (b[3::4] << 24))
    return cv.astype(np.uint32).view(np.int32), np.asarray(offs, np.int32)


def random_cases(dev):
    """Seeded random inputs at the 1080p main-path shapes:
    {wrapper name: [(args, kwargs), ...]}."""
    import torch
    rng = np.random.default_rng(2024)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    H, W, bd = 1088, 1920, 8
    cases = {name: [] for _, name in WRAPPERS}
    for S, N in ((4, 4096), (8, 2048), (16, 512), (32, 128)):
        cv, coff = _csr_bin(rng, N, S)
        cases["densify_bin"].append(((t(cv), t(coff)), {"N": N, "S": S}))

    def luma_params(a, b):
        return (t(rng.integers(0, 3, (a, b)).astype(np.int32)),
                t((rng.integers(0, 65, (a, b)) << (bd - 8)).astype(np.int32)),
                t((rng.integers(0, 25, (a, b)) << (bd - 8)).astype(np.int32)),
                t((rng.random((a, b)) < 0.1).astype(np.int32)),
                t((rng.random((a, b)) < 0.1).astype(np.int32)))

    img = rng.integers(0, 1 << bd, (H, W + 8)).astype(np.int32)
    cases["luma_pass"].append(((t(img), *luma_params(H // 4, W // 8)),
                               {"bit_depth": bd}))
    img = rng.integers(0, 1 << bd, (H + 8, W)).astype(np.int32)
    cases["luma_pass_h"].append(((t(img), *luma_params(H // 8, W // 4)),
                                 {"bit_depth": bd}))

    def chroma_params(a, b):
        tcs = rng.integers(0, 25, (2, a, b)).astype(np.int32)
        tcs[rng.random((2, a, b)) < 0.5] = 0
        return (t(tcs), t((rng.random((a, b)) < 0.1).astype(np.int32)),
                t((rng.random((a, b)) < 0.1).astype(np.int32)))

    Hc, Wc = H // 2, W // 2
    imgs = rng.integers(0, 1 << bd, (2, Hc, Wc + 8)).astype(np.int32)
    cases["chroma_pass_stacked"].append(
        ((t(imgs), *chroma_params(H // 4, Wc // 8)),
         {"bit_depth": bd, "rows_per_seg": 2}))
    imgs = rng.integers(0, 1 << bd, (2, Hc + 8, Wc)).astype(np.int32)
    cases["chroma_pass_stacked_h"].append(
        ((t(imgs), *chroma_params(Hc // 8, W // 4)),
         {"bit_depth": bd, "cols_per_seg": 2}))

    for edge_ok in (True, False):
        args = (t(rng.integers(0, 256, (H, W)).astype(np.int32)),
                t(rng.integers(0, 3, (H, W)).astype(np.int32)),
                t(rng.integers(0, 4, (H, W)).astype(np.int32)),
                t(rng.integers(0, 32, (H, W)).astype(np.int32)),
                t(rng.integers(-7, 8, (H, W, 4)).astype(np.int32)),
                t(rng.random((H, W)) < 0.05))
        kw = {"bit_depth": 8,
              "edge_ok": t(rng.random((H, W)) > 0.1) if edge_ok else None}
        cases["sao_plane_fused"].append((args, kw))
    return cases


def plain_of(name):
    """The plain PyTorch version of a wrapper (run on the same device)."""
    import torch
    from libde265_tpu_torch.ops import coef_cuda
    from libde265_tpu_torch.ops.deblock import _chroma_pass, _luma_pass
    from libde265_tpu_torch.ops.sao import sao_plane

    if name == "densify_bin":
        return lambda cv, coff, N, S: coef_cuda.densify_bin_plain(cv, coff,
                                                                  N, S)
    if name == "luma_pass":
        return _luma_pass
    if name == "luma_pass_h":
        return lambda img, *p, bit_depth: _luma_pass(
            img.T, *(a.T for a in p), bit_depth=bit_depth).T
    if name == "chroma_pass_stacked":
        return lambda imgs, tcs, no_p, no_q, bit_depth, rows_per_seg: \
            torch.stack([_chroma_pass(imgs[c], tcs[c], no_p, no_q, bit_depth,
                                      rows_per_seg) for c in range(2)])
    if name == "chroma_pass_stacked_h":
        return lambda imgs, tcs, no_p, no_q, bit_depth, cols_per_seg: \
            torch.stack([_chroma_pass(imgs[c].T, tcs[c].T, no_p.T, no_q.T,
                                      bit_depth, cols_per_seg).T
                         for c in range(2)])
    return sao_plane


def kernel_of(name):
    coef, dbk, sao = kernel_modules()
    return getattr({"densify_bin": coef, "sao_plane_fused": sao}.get(
        name, dbk), name)


def median_ms(fn, reps=25, warm=3):
    import torch
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


FAMILY = {"densify_bin": 0, "luma_pass": 1, "luma_pass_h": 1,
          "chroma_pass_stacked": 2, "chroma_pass_stacked_h": 2,
          "sao_plane_fused": 3}


def compare_kernels(case_sets, timed):
    """Exact kernel-vs-plain comparison on every case; times (kernel, plain)
    summed per family over the calls of one picture (`timed`)."""
    import torch
    names = list(KERNELS)
    err = {n: 0 for n in names}
    ncases = {n: 0 for n in names}
    for label, cases in case_sets:
        for name, calls in cases.items():
            fam = names[FAMILY[name]]
            for args, kw in calls:
                got = kernel_of(name)(*args, **kw)
                want = plain_of(name)(*args, **kw)
                torch.cuda.synchronize()
                if got.shape != want.shape:
                    raise AssertionError(f"{name} ({label}): shape "
                                         f"{tuple(got.shape)} vs "
                                         f"{tuple(want.shape)}")
                e = int((got.long() - want.long()).abs().max().item()) \
                    if got.numel() else 0
                err[fam] = max(err[fam], e)
                ncases[fam] += 1
                if e != 0:
                    raise AssertionError(f"{name} ({label}): kernel differs "
                                         f"from the plain version by {e}")
    ms = {n: 0.0 for n in names}
    plain_ms = {n: 0.0 for n in names}
    for name, calls in timed.items():
        fam = names[FAMILY[name]]
        for args, kw in calls:
            k, p = kernel_of(name), plain_of(name)
            # plain, kernel, kernel, plain: both halves see the same card
            t_p1 = median_ms(lambda: p(*args, **kw))
            t_k1 = median_ms(lambda: k(*args, **kw))
            t_k2 = median_ms(lambda: k(*args, **kw))
            t_p2 = median_ms(lambda: p(*args, **kw))
            ms[fam] += min(t_k1, t_k2)
            plain_ms[fam] += min(t_p1, t_p2)
    return err, ncases, ms, plain_ms


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main():
    smi = card_check()
    import torch

    # ---- phase 2: build ----
    t_native = build_native()
    from libde265_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.lib()
    t_kern = time.perf_counter() - t0
    log(f"build: native library {t_native:.1f} s, CUDA kernels "
        f"{t_kern:.1f} s (nvcc {_build.build_seconds} s)")

    import libde265_tpu_torch as lt
    dev = torch.device("cuda")

    # ---- phase 3: main path at 1080p ----
    frames = 8
    data, t_enc = make_stream(BUILD / "chip_smoke" / f"1080p_{frames}f.h265",
                              1920, 1088, frames, 32,
                              {"intra-period": 4, "sao": True})
    log(f"stream: 1920x1088, {frames} frames, {len(data)} bytes, encoded in "
        f"{t_enc:.1f} s")
    _, progs = oracle_programs(data)
    is_intra = [len(p.pus) == 0 for p in progs]

    warm = lt.PipelinedDecoder(device=dev)     # CUDA / cuBLAS set-up
    warm.decode_stream(data)
    torch.cuda.synchronize()

    pd = lt.PipelinedDecoder(device=dev)
    reset_counts()
    t0 = time.perf_counter()
    outs = pd.decode_stream(data)
    torch.cuda.synchronize()
    t_e2e = time.perf_counter() - t0
    counts = read_counts()
    assert_bit_exact(outs, progs, "1080p")
    for name, n in counts.items():
        if n < frames:
            raise AssertionError(f"{name}: {n} launches in {frames} frames")
    log(f"1080p main path: {frames} frames bit-exact; e2e "
        f"{frames / t_e2e:.3f} fps ({1000 * t_e2e / frames:.1f} ms/frame) "
        f"on {smi}")
    log(f"launches in the main-path run: {json.dumps(counts)}")

    # per-frame synced times (I/P split)
    fd = lt.FusedDecoder(device=dev)
    fd.plan_stream(progs)
    per = []
    for p in progs:
        t0 = time.perf_counter()
        fd.decode(p)
        torch.cuda.synchronize()
        per.append(1000 * (time.perf_counter() - t0))
    ims = [m for m, i in zip(per, is_intra) if i]
    pms = [m for m, i in zip(per, is_intra) if not i]
    log(f"per-frame ms (synced): {[round(m, 1) for m in per]}; I median "
        f"{statistics.median(ims) if ims else 'n/a'}, P median "
        f"{statistics.median(pms) if pms else 'n/a'} on {smi}")
    del outs, fd

    # ---- phase 4: kernels vs plain on the card ----
    first_i = is_intra.index(True)
    first_p = is_intra.index(False)
    fd = lt.FusedDecoder(device=dev)
    fd.plan_stream(progs)
    caps = capture_inputs(fd, progs[:first_p + 1])
    del fd
    err, ncases, ms, plain_ms = compare_kernels(
        [("random", random_cases(dev)),
         (f"frame {first_i} (I)", caps[first_i]),
         (f"frame {first_p} (P)", caps[first_p])],
        caps[first_p])
    for n in KERNELS:
        log(f"{n}: {ncases[n]} cases equal to the plain version (tolerance "
            f"0, integer); P-frame {ms[n]:.4f} ms vs plain {plain_ms[n]:.4f} "
            f"ms on {smi}")

    # ---- phase 5: small B / weighted / 2-ref stream ----
    bdata, _ = make_stream(BUILD / "chip_smoke" / "416x240_bw.h265", 416, 240,
                           8, 30, {"intra-period": 8, "b-slices": True,
                                   "weighted-pred": True, "num-refs": 2})
    _, bprogs = oracle_programs(bdata)
    bouts = lt.PipelinedDecoder(device=dev).decode_stream(bdata)
    torch.cuda.synchronize()
    assert_bit_exact(bouts, bprogs, "416x240 B/weighted")
    n_bi = sum(int((p.pus["pred_flags"] == 3).sum()) for p in bprogs
               if len(p.pus))
    log(f"416x240 B/weighted/2-ref: {len(bprogs)} frames bit-exact "
        f"({n_bi} bi-predicted PUs)")

    jax_mods = sorted(m for m in sys.modules
                      if m == "jax" or m.startswith("jax."))
    if jax_mods:
        raise AssertionError(f"the port imported JAX: {jax_mods[:5]}")

    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[n], "max_abs_err": err[n], "ms": ms[n],
                "plain_ms": plain_ms[n]}
               for n, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
