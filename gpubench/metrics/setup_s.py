"""setup_s: seconds from the process's start to the window's start, less
the clip's encode (the load generator's work, printed as encode_s):
imports, the native and kernel builds or their cache hits, the entry's
construction and its warm-up on the cell's own requests."""


def read(run):
    return run.setup_s
