"""The port's numpy feed packer returns the JAX packer's feed word for word
(layout, buffer, size bins and slice count) on every picture of two GOPs,
with and without pre-planned capacities."""
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
