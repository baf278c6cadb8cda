"""parse_wait_ms: host ms a picture of PipelinedDecoder.decode_stream's calling
thread waiting for the parse thread (one span a wait).

The program's span tde.stream.wait over the profiled requests: its self ms
(libde265_tpu_torch.tracing.summary()) over the count of tde.decode.
None where nothing was profiled, or the program has no spans."""
SPAN = "tde.stream.wait"


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
