"""HEVC profile and level descriptors (spec Annex A).

A copy of ``libde265_tpu/models/profiles.py``, kept here so that the port's
encoder never imports the JAX package.

Consulted by encoder.Encoder for automatic/validated general_level_idc
selection; the native decoder performs the same checks at SPS-parse time
(native/src/params.cc annex_a_* + decoder.cc read_sps) and surfaces
DE265_WARNING_UNSUPPORTED_PROFILE / DE265_WARNING_LEVEL_LIMITS_EXCEEDED.
The two tables are kept in sync (tests/test_parallel.py).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Profile:
    name: str
    idc: int
    max_bit_depth: int
    chroma_formats: tuple = (1,)  # chroma_format_idc values allowed
    intra_only: bool = False
    range_extension: bool = False


MAIN = Profile("Main", 1, 8)
MAIN10 = Profile("Main 10", 2, 10)
MAIN_STILL = Profile("Main Still Picture", 3, 8, intra_only=True)
REXT = Profile("Format range extensions", 4, 16, (0, 1, 2, 3),
               range_extension=True)

PROFILES = {p.idc: p for p in (MAIN, MAIN10, MAIN_STILL, REXT)}


@dataclass(frozen=True)
class Level:
    idc: int                # level_idc = level * 30
    max_luma_ps: int        # max luma picture size (samples)
    max_luma_sr: int        # max luma sample rate (samples/sec)
    max_br_main_kbps: int   # max bitrate, Main tier


# spec Table A.8/A.9 (Main tier)
LEVELS = [
    Level(30, 36864, 552960, 128),
    Level(60, 122880, 3686400, 1500),
    Level(63, 245760, 7372800, 3000),
    Level(90, 552960, 16588800, 6000),
    Level(93, 983040, 33177600, 10000),
    Level(120, 2228224, 66846720, 12000),
    Level(123, 2228224, 133693440, 20000),
    Level(150, 8912896, 267386880, 25000),
    Level(153, 8912896, 534773760, 40000),
    Level(156, 8912896, 1069547520, 60000),
    Level(180, 35651584, 1069547520, 60000),
    Level(183, 35651584, 2139095040, 120000),
    Level(186, 35651584, 4278190080, 240000),
]


def level_limits(level_idc: int) -> Level:
    """Smallest level whose idc >= the requested one."""
    for lv in LEVELS:
        if lv.idc >= level_idc:
            return lv
    return LEVELS[-1]


def min_level_for(width: int, height: int, fps: float = 30.0) -> Level:
    ps = width * height
    sr = ps * fps
    for lv in LEVELS:
        if lv.max_luma_ps >= ps and lv.max_luma_sr >= sr:
            return lv
    return LEVELS[-1]
