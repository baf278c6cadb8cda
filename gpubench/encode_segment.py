"""Encode one segment of a benchmark clip (one worker process).

    python gpubench/encode_segment.py '<json job>'

The job names the native library, the picture size, the encoder's
parameters, the content model's parameters, the seed, the clip's length
and the segment's first picture and picture count, and the output file.
The segment is written to `out` + ".part" and renamed into place.
"""
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from gbench import en265  # noqa: E402
from gbench.content import Scene  # noqa: E402


def main(job: dict) -> None:
    scene = Scene(job["seed"], job["height"], job["width"],
                  job["clip_frames"], job["content"])
    L = en265.load(Path(job["lib"]))
    parts = []
    with en265.Encoder(L, job["encoder"]) as enc:
        for t in range(job["first"], job["first"] + job["frames"]):
            parts.append(enc.encode(*scene.frame(t), pts=t))
        parts.append(enc.finish())
    out = Path(job["out"])
    tmp = out.with_name(out.name + ".part")
    tmp.write_bytes(b"".join(parts))
    os.replace(tmp, out)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
