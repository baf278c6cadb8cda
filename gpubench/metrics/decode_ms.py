"""decode_ms: host ms a picture of FusedDecoder.decode(prog) followed by
torch.cuda.synchronize() on the clip's parse-only programs (feed pack,
upload, frame program), averaged over the pictures."""


def read(run):
    d = run.probe.decode_s if run.probe else []
    return 1000.0 * sum(d) / len(d) if d else None
