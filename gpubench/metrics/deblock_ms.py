"""deblock_ms: host ms a picture of the deblocking (kernels B8, B9) and its
skip mask.

The program's span tde.deblock over the profiled requests: its self ms
(libde265_tpu_torch.tracing.summary()) over the count of tde.decode.
None where nothing was profiled, or the program has no spans."""
SPAN = "tde.deblock"


def read(run):
    if run.trace_data is None:
        return None
    try:
        from libde265_tpu_torch import tracing
    except ImportError:     # a program without spans
        return None
    s = tracing.summary()
    n = s.get("tde.decode", {}).get("count", 0)
    if not n:
        return None
    return s.get(SPAN, {}).get("self_ms", 0.0) / n
