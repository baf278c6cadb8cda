"""device_mem_gib: torch.cuda.max_memory_allocated() over the window (its
peak statistics reset at the window's start), in GiB; none off the card."""


def read(run):
    b = run.window.memory_peak_bytes
    return b / 2**30 if b else None
