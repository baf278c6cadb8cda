"""parse_ms: host ms a picture of the native parse alone (a parse-only
Decoder, as PipelinedDecoder's parse thread runs it) over the cell's clip.
Timing copied from chip_smoke.parse_ms."""


def read(run):
    p = run.probe
    return 1000.0 * p.parse_s / p.pictures if p and p.pictures else None
