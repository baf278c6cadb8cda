"""The plain reference that decides `correct`.

The expected output of every picture is the encoder's own reconstruction,
which an HEVC encoder must share bit for bit with every conforming
decoder.  The in-repo encoder writes it into the stream as the standard's
decoded picture hash (a suffix SEI message, payload type 132, hash type 0:
one MD5 per colour component over the whole decoded picture, row by row,
one byte a sample at 8 bits and two, low byte first, above).  This module
reads those hashes with its own NAL and SEI reader and hashes the planes
the program produced the same way.  It imports nothing of the program and
takes nothing the program made: only the bytes of the stream and the
program's output planes, which it judges.
"""
from __future__ import annotations

import hashlib

import numpy as np

SEI_SUFFIX = 40
DECODED_PICTURE_HASH = 132


def nal_units(data: bytes):
    """(nal_unit_type, bytes after the start code) of each NAL unit of an
    Annex-B byte stream, in order."""
    out, i, starts = [], 0, []
    while True:
        i = data.find(b"\x00\x00\x01", i)
        if i < 0:
            break
        starts.append(i + 3)
        i += 3
    for k, s in enumerate(starts):
        end = starts[k + 1] - 3 if k + 1 < len(starts) else len(data)
        unit = data[s:end].rstrip(b"\x00")
        if len(unit) >= 2:
            out.append(((unit[0] >> 1) & 0x3F, unit))
    return out


def rbsp(unit: bytes) -> bytes:
    """The unit's payload after its two header bytes, emulation
    prevention bytes (0x000003 -> 0x0000) removed."""
    out, zeros = bytearray(), 0
    for b in unit[2:]:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _sei_messages(payload: bytes):
    i = 0
    while i < len(payload) and not (payload[i] == 0x80 and
                                     i == len(payload) - 1):
        ptype = 0
        while payload[i] == 0xFF:
            ptype += 255
            i += 1
        ptype += payload[i]
        i += 1
        size = 0
        while payload[i] == 0xFF:
            size += 255
            i += 1
        size += payload[i]
        i += 1
        yield ptype, payload[i:i + size]
        i += size


def picture_hashes(data: bytes):
    """The MD5 digests ([16-byte digest per plane]) of every picture of
    the stream in decode order.  Raises ValueError where a picture has no
    hash or a hash follows no picture."""
    hashes, pictures = [], 0
    for t, unit in nal_units(data):
        if t < 32 and len(unit) > 2 and unit[2] & 0x80:
            pictures += 1            # first_slice_segment_in_pic_flag
        elif t == SEI_SUFFIX:
            for ptype, body in _sei_messages(rbsp(unit)):
                if ptype != DECODED_PICTURE_HASH:
                    continue
                if body[0] != 0:
                    raise ValueError(f"hash type {body[0]} is not MD5")
                n = (len(body) - 1) // 16
                if len(hashes) != pictures - 1:
                    raise ValueError("a decoded picture hash follows no "
                                     "picture")
                hashes.append([bytes(body[1 + 16 * c:17 + 16 * c])
                               for c in range(n)])
    if len(hashes) != pictures:
        raise ValueError(f"{pictures} pictures, {len(hashes)} hashes")
    return hashes


def plane_md5(plane: np.ndarray, bit_depth: int) -> bytes:
    """MD5 of one plane as the decoded picture hash defines it."""
    if bit_depth > 8:
        raw = np.ascontiguousarray(plane, "<u2").tobytes()
    else:
        raw = np.ascontiguousarray(plane, np.uint8).tobytes()
    return hashlib.md5(raw).digest()


def judge(planes, want, bit_depth: int = 8) -> int:
    """The number of planes of one picture that differ from their hash
    (int planes; a sample outside the bit depth's range is a difference
    whatever the hash says)."""
    bad = 0
    if len(planes) != len(want):
        return max(len(planes), len(want))
    top = (1 << bit_depth) - 1
    for plane, digest in zip(planes, want):
        a = np.asarray(plane)
        if a.size and (a.min() < 0 or a.max() > top):
            bad += 1
        elif plane_md5(a, bit_depth) != digest:
            bad += 1
    return bad
