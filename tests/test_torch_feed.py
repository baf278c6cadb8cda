"""The port's numpy feed packer returns the JAX packer's feed word for word
(layout, buffer, size bins and slice count) on every picture of the test
GOPs, with and without pre-planned capacities, in both formulations: the
use_pallas_mc=False feed and the production (use_pallas_mc) feed."""
import numpy as np
import pytest

from libde265_tpu.fused_decode import FusedDecoder as JaxFusedDecoder

from libde265_tpu_torch.feed import MAX_REFS, FeedPacker

from _torch_common import gop_bytes, programs


@pytest.mark.parametrize("plan", [False, True], ids=["watermarks", "planned"])
@pytest.mark.parametrize("stream", ["p-sao", "b-tmvp"])
def test_feed_matches_jax_packer(native_build, stream, plan):
    _, progs = programs(gop_bytes(stream))
    jfd = JaxFusedDecoder()
    assert not jfd.use_pallas_mc
    packer = FeedPacker()
    if plan:
        jfd.plan_stream(progs)
        packer.plan_stream(progs)
    for i, prog in enumerate(progs):
        slot_map = {k: k for k in range(min(len(prog.ref_pocs), MAX_REFS))}
        j_layout, j_buf, j_lgs, j_ns = jfd._pack_numpy(prog, slot_map, None)
        layout, buf, lgs, ns = packer.pack(prog, slot_map)
        assert layout == j_layout, i
        np.testing.assert_array_equal(buf, j_buf, err_msg=f"frame {i}")
        assert lgs == j_lgs and ns == j_ns, i
        assert packer.use_l1 == jfd._use_l1
        assert sorted(packer.intra_lgs) == sorted(jfd._intra_lgs)


@pytest.mark.parametrize("plan", [False, True], ids=["watermarks", "planned"])
@pytest.mark.parametrize("stream", ["p-sao", "b-tmvp", "10bit"])
def test_production_feed_matches_jax_packer(native_build, stream, plan):
    """The use_pallas_mc feed: JAX's _pack_numpy (called directly, so that
    the native packer does not stand in for it) against the port's packer
    with pallas_mc, on ring-slot maps that are not the identity."""
    _, progs = programs(gop_bytes(stream))
    jfd = JaxFusedDecoder()
    jfd.use_pallas_mc = True
    jfd._no_native_pack = True      # plan_stream's numpy watermarks too
    packer = FeedPacker()
    if plan:
        jfd.plan_stream(progs)
        packer.plan_stream(progs, pallas_mc=True)
    for i, prog in enumerate(progs):
        n = min(len(prog.ref_pocs), MAX_REFS)
        slot_map = {k: (5 * k + 3) % (2 * MAX_REFS) for k in range(n)}
        slot_row = np.array([i * 7, i * 5, i * 5], np.int32)
        j_layout, j_buf, j_lgs, j_ns = jfd._pack_numpy(prog, slot_map,
                                                       slot_row)
        layout, buf, lgs, ns = packer.pack(prog, slot_map, slot_row,
                                           pallas_mc=True)
        assert layout == j_layout, i
        np.testing.assert_array_equal(buf, j_buf, err_msg=f"frame {i}")
        assert lgs == j_lgs and ns == j_ns, i
        assert packer.use_l1 == jfd._use_l1
        assert packer.caps == {k: v for k, v in jfd.caps.items()
                               if not k.startswith("cc")}
