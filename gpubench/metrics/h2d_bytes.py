"""h2d_bytes: FusedDecoder.last_wire_bytes (the bytes of a picture's feed
upload) averaged over the pictures that upload a feed, in bytes a
picture."""


def read(run):
    b = [x for x in (run.probe.wire_bytes if run.probe else [])
         if x is not None]
    return sum(b) / len(b) if b else None
