"""upload_ms: host ms a picture of the feed upload
(FusedDecoder._sparse_upload: block compaction, pinned copies, the wait for
a scratch slot, kernel B1).

The program's span tde.upload over the profiled requests: its self ms
(libde265_tpu_torch.tracing.summary()) over the count of tde.decode.
None where nothing was profiled, or the program has no spans."""
SPAN = "tde.upload"


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
