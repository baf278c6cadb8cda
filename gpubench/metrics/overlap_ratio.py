"""overlap_ratio: the window's ms a picture over the slower of the two
stages measured alone, max(parse_ms, decode_ms).  1.0: the pipeline runs
at its slowest stage; above 1, the stages do not overlap fully."""


def read(run):
    p, w = run.probe, run.window
    if not p or not p.pictures or not p.decode_s or not w.pictures:
        return None
    parse = p.parse_s / p.pictures
    decode = sum(p.decode_s) / len(p.decode_s)
    return (w.wall_s / w.pictures) / max(parse, decode)
