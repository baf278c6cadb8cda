"""The port against the scalar oracle on the stream corpus of
scripts/make_corpus.py: every stream that the corpus marks "exact" decoded
by FusedDecoder(device="cpu") under the production formulation
(use_pallas_mc, the card's default), every plane of every frame equal to
the oracle's planes (prog.planes), tolerance 0.

The corpus is made while pytest collects (tests/_torch_common.py,
ensure_corpus), so its manifest is read here at collection; this file
reads the checkout's own copy (OWN_CORPUS), the packer's test the copy in
/tmp that other checkouts share.  The "nocrash"
mutants are left out: their names depend on which decoders built them.
Every picture is packed by the native packer (FeedPacker.pack_native),
except in the two streams with cross-component prediction: plan_stream
latches CCP, and their pictures go to the numpy packer (the packer's
counters say which ran).  Those two decode exactly as the others do.
The two largest streams, level_edge_64x8192 and level_edge_8192x64
(about 30 s of the file's 110 s on a CPU), are left out here to keep the
file near 80 s.

On a CUDA card (the `gpu` test) FusedDecoder() decodes every exact stream,
both level_edge ones included, with the hand-written kernels: 4:2:2 and
4:4:4 chroma, 4:0:0, odd plane sizes, slices and tiles that switch
filtering off across their boundaries, 8192-wide and 8192-high pictures.

Beyond the JAX package: conf_window_104x72 has a 52x36 chroma plane, whose
last deblocking edges (x = 48, y = 32) the JAX package's picture program
drops (it counts Wc // 8 and Hc // 8 chroma edges); the port counts them
and equals the oracle there.
"""
import json
import os

import numpy as np
import pytest

from libde265_tpu_torch import FusedDecoder

from _torch_common import CORPUS, OWN_CORPUS, cuda, programs  # noqa: F401
from test_native_pack import STREAMS as PACK_STREAMS

CCP = {"chroma444_ccp", "rext_price_ccp_444"}
LARGEST = {"level_edge_64x8192", "level_edge_8192x64"}
EXACT = sorted(name for name, mode in
               json.loads((OWN_CORPUS / "manifest.json").read_text()).items()
               if mode == "exact" and name not in LARGEST)


def test_corpus_ready_at_collection():
    """Both copies of the corpus are complete once _torch_common is
    imported, and the packer test finds its streams in the shared one
    (tests/test_native_pack.py skips the streams it does not find)."""
    for corpus in (OWN_CORPUS, CORPUS):
        assert (corpus / "manifest.json").exists()
    corpus = [s for s in PACK_STREAMS if s.startswith(str(CORPUS))]
    assert len(corpus) == 13
    missing = [s for s in corpus if not os.path.exists(s)]
    assert not missing, missing
    assert "conf_window_104x72" in EXACT and CCP <= set(EXACT)


def _decode_exact(fd, name):
    """Every frame of the corpus stream through fd (production
    formulation), every plane equal to the oracle's; every picture packed
    natively, or by numpy in a stream with CCP."""
    _, progs = programs((OWN_CORPUS / f"{name}.h265").read_bytes())
    assert progs
    ccp = any((p.tus["cross_comp_scale"] != 0).any() for p in progs)
    assert ccp == (name in CCP)
    fd.plan_stream(progs)       # latches CCP before the first picture
    for i, p in enumerate(progs):
        planes = fd.decode(p)
        want = [q for q in p.planes if q is not None]     # 4:0:0: luma only
        assert len(planes) == len(want)
        for c, (got, w) in enumerate(zip(planes, want)):
            np.testing.assert_array_equal(got.cpu().numpy(), w,
                                          err_msg=f"{name} frame {i} "
                                                  f"plane {c}")
    pk = fd.packer
    n_native = 0 if ccp else len(progs)
    assert (pk.native_packs, pk.numpy_packs) == \
        (n_native, len(progs) - n_native)


@pytest.mark.parametrize("name", EXACT)
def test_corpus_stream_bit_exact(native_build, name):
    fd = FusedDecoder(device="cpu")
    fd.use_pallas_mc = True
    _decode_exact(fd, name)


@pytest.mark.gpu
@pytest.mark.parametrize("name", EXACT + sorted(LARGEST))
def test_corpus_stream_bit_exact_on_card(cuda, native_build, name):  # noqa: F811
    fd = FusedDecoder()
    assert fd.device.type == "cuda" and fd.use_pallas_mc
    _decode_exact(fd, name)
