"""parse_threads: the substream workers of the profiled request's parse,
the counter PipelinedDecoder.parse_threads that the program notes on the
tde.request span's Record (0 where the parse ran on its thread alone).

None where nothing was profiled, or the program notes no such counter."""
SPAN = "tde.request"


def read(run):
    if run.trace_data is None:
        return None
    try:
        from libde265_tpu_torch import tracing
    except ImportError:     # a program without spans
        return None
    reqs = [r for r in tracing.records() if r.name == SPAN]
    args = getattr(reqs[-1], "args", None) if reqs else None
    return (args or {}).get("parse_threads")
