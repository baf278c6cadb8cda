"""The port's PipelinedDecoder with the JAX package's interface:
PipelinedDecoder(fused=, device=), warm, reset and
decode_stream(data, chunk=, on_frame=).

Counterparts of tests/test_stream.py (warm, then a decode bit-exact
against the scalar oracle; on_frame), in both formulations; an explicit
`fused` keeps its device; two different streams through one decoder with
reset between them; and the repair of ROADMAP C9: reset forgets the DPB
ring too, so that a seek into another stream after it reads the planes
the parser attached, not a slot of the previous stream under the same POC.
"""
import numpy as np
import pytest

import libde265_tpu_torch as lt
from libde265_tpu_torch import FusedDecoder, PipelinedDecoder

from _torch_common import gop_bytes, programs
from test_stream import _make_stream

FORMULATIONS = {"production": True, "per-cell": False}


def _decoder(production, device="cpu"):
    fd = FusedDecoder(device=device)
    fd.use_pallas_mc = production
    return PipelinedDecoder(fused=fd)


def _assert_oracle(outs, progs, what=""):
    assert len(outs) == len(progs)
    for i, (planes, prog) in enumerate(zip(outs, progs)):
        for c, pl in enumerate(planes):
            np.testing.assert_array_equal(pl.numpy(), prog.planes[c],
                                          err_msg=f"{what} frame {i} plane "
                                                  f"{c}")


@pytest.mark.parametrize("form", list(FORMULATIONS))
def test_pipelined_stream_bit_exact(native_build, form):
    """warm (parse, plan, decode, reset), then the decode with the parser
    fed 1 KiB at a time."""
    data = _make_stream()
    _, progs = programs(data)
    pd = _decoder(FORMULATIONS[form])
    assert pd.warm(data) == len(progs) == 8
    assert not pd.fd.dpb and not pd.fd._slot_of and pd.fd._stack is None
    _assert_oracle(pd.decode_stream(data, chunk=1 << 10), progs)


def test_pipelined_on_frame_callback(native_build):
    data = _make_stream(n_frames=4)
    _, progs = programs(data)
    seen = []
    pd = PipelinedDecoder(device="cpu")
    outs = pd.decode_stream(data, on_frame=lambda i, p: seen.append((i, p)))
    assert outs == []
    assert [i for i, _ in seen] == [0, 1, 2, 3]
    _assert_oracle([p for _, p in seen], progs)


def test_fused_is_kept():
    """An explicit FusedDecoder is used as it is, its device too;
    `device` serves only the default one."""
    fd = FusedDecoder(device="cpu", run_sao=False)
    pd = PipelinedDecoder(fused=fd, device="cuda")
    assert pd.fd is fd and pd.fd.device.type == "cpu"
    assert PipelinedDecoder(device="cpu").fd.device.type == "cpu"
    assert PipelinedDecoder().fd.device.type == "cuda"
    assert lt.Picture.__name__ == "Picture"


@pytest.mark.parametrize("form", list(FORMULATIONS))
def test_two_streams_with_reset(native_build, form):
    """A 96x96 8-bit stream, reset, then a 64x48 10-bit one through the
    same decoder: both equal their oracle, and reset leaves no picture
    and no ring (the second stream allocates its own, at its size)."""
    pd = _decoder(FORMULATIONS[form])
    for name in ("p-sao", "10bit"):
        data = gop_bytes(name)
        _assert_oracle(pd.decode_stream(data), programs(data)[1], name)
        pd.reset()
        assert not pd.fd.dpb and not pd.fd._order
        assert not pd.fd._slot_of and not pd.fd._slot_lru
        assert pd.fd._stack is None


def test_reset_forgets_the_ring(native_build):
    """C9: stream A decoded, reset, then a seek into stream B (same size,
    same POCs) at a P picture with the parser's planes attached.  Clearing
    only dpb and _order, as the JAX package's reset does, leaves A's
    reference in the ring under B's reference POC and gives a wrong
    picture; reset gives B's oracle picture."""
    _, a = programs(gop_bytes("p-sao"))
    _, b = programs(gop_bytes("2refs"))
    k = 3
    assert len(b[k].pus) and b[k].ref_planes
    assert set(b[k].ref_pocs) <= {p.poc for p in a}

    def seek(clear):
        pd = _decoder(True)
        for p in a:
            pd.fd.decode(p)
        clear(pd)
        return pd.fd.decode(b[k])

    def jax_reset(pd):
        pd.fd.dpb.clear()
        pd.fd._order.clear()

    def reset(pd):
        pd.reset()
        assert pd.fd._slot_of == {} and pd.fd._slot_lru == []

    wrong = seek(jax_reset)
    assert not np.array_equal(wrong[0].numpy(), b[k].planes[0])
    got = seek(reset)
    for c in range(3):
        np.testing.assert_array_equal(got[c].numpy(), b[k].planes[c])
