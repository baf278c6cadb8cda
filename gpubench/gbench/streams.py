"""The clip of one configuration and seed.

A configuration's segments (independently decodable, each starting with
an IDR) are encoded once, one segment per worker process (the in-repo
encoder through ``encode_segment.py``), and cached inside the checkout
under ``build/gpubench/streams/`` by configuration and a hash of
everything that shapes them.  Segment k is the first pictures of its own
scene, drawn from ``content_seed + k``, so that a clip holds as many
scenes as segments.  The run's seed draws the order of the segments in the
clip: every seed decodes the same pictures, the same work, in another
order."""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np

# bump when the content model or the encode path changes the stream a
# configuration and seed give
GENERATOR_VERSION = 2

_WORKER = Path(__file__).resolve().parent.parent / "encode_segment.py"


@dataclass
class Clip:
    segments: list      # bytes of each segment, in the clip's order
    order: list         # the encoded segment each position holds
    data: bytes         # the segments concatenated: the clip
    pictures: int       # pictures in the clip
    encode_s: float     # wall seconds of the encode (0.0 from the cache)
    cached: bool
    workers: int

    def mbit_per_s(self, fps: float) -> float:
        return 8 * len(self.data) * fps / self.pictures / 1e6

    def md5(self) -> str:
        return hashlib.md5(self.data).hexdigest()


def stream_key(cfg: dict) -> str:
    shape = {k: cfg[k] for k in ("width", "height", "fps", "segments",
                                 "pictures_per_segment", "encoder",
                                 "content", "content_seed")}
    shape["generator"] = GENERATOR_VERSION
    blob = json.dumps(shape, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def clip_for(root: Path, lib: Path, cfg: dict, seed: int,
             workers: int = 0) -> Clip:
    """The clip of configuration `cfg` for `seed`: its segments from the
    cache under root/build/gpubench/streams, or encoded now by the native
    library `lib` with `workers` processes (0: os.cpu_count()), in the
    order the seed draws."""
    n, per = int(cfg["segments"]), int(cfg["pictures_per_segment"])
    content_seed = int(cfg["content_seed"])
    cache = (root / "build" / "gpubench" / "streams" /
             f"{cfg['name']}-{stream_key(cfg)}")
    paths = [cache / f"segment{k:03d}.h265" for k in range(n)]
    workers = workers or os.cpu_count() or 1
    missing = [k for k, p in enumerate(paths) if not p.exists()]
    t0 = time.perf_counter()
    if missing:
        cache.mkdir(parents=True, exist_ok=True)

        def encode(k):
            job = {"lib": str(lib), "width": cfg["width"],
                   "height": cfg["height"], "encoder": cfg["encoder"],
                   "content": cfg["content"], "seed": content_seed + k,
                   "clip_frames": per, "first": 0, "frames": per,
                   "out": str(paths[k])}
            r = subprocess.run([sys.executable, str(_WORKER),
                                json.dumps(job)], capture_output=True,
                               text=True)
            if r.returncode != 0:
                raise RuntimeError(f"encoding segment {k} of {cfg['name']} "
                                   f"seed {seed} failed ({r.returncode}):\n"
                                   f"{r.stderr[-4000:]}")

        with ThreadPoolExecutor(max_workers=min(workers, len(missing))) as ex:
            for fut in [ex.submit(encode, k) for k in missing]:
                fut.result()
    encode_s = time.perf_counter() - t0 if missing else 0.0
    order = [int(k) for k in
             np.random.default_rng([int(seed), 0x6F72]).permutation(n)]
    segs = [paths[k].read_bytes() for k in order]
    return Clip(segments=segs, order=order, data=b"".join(segs),
                pictures=n * per,
                encode_s=encode_s, cached=not missing,
                workers=min(workers, len(missing)) if missing else 0)
