"""gop_parse_share: GopParallelDecoder.last_parse_s (the concurrent parse
of every segment, before any decode) summed over the window's requests,
as a share of the window's wall time (%)."""


def read(run):
    w = run.window
    if not w.parse_s:
        return None
    return 100.0 * sum(w.parse_s) / w.wall_s
