"""The hybrid family through the whole slice: the checks of
tests/test_torch_stateful_engine.py on the smoke ``jamba-1.5-large-398b``
pair (Mamba and GQA attention layers, MLP and mixture-of-experts channel
mixers), in float32 on the CPU -- fixed-batch K-SQS and C-SQS rounds
equal to the reference's (the C-SQS beta within the pinned ulps),
rolled-back caches equal to a fresh prefill of the verified prefix, and
a lockstep trace with slot reuse equal to the reference's -- and the
paged pool: only the attention layers are paged, and the paged trace's
streams and report equal the dense one's and the reference's paged
run."""
import pytest

pytest.importorskip("torch")

import test_torch_stateful_engine as st  # noqa: E402
from repro_torch.models.attention import PagedSpec  # noqa: E402

ARCH = "jamba-1.5-large-398b"
# the divergence measured at these seeds, per round: the largest ulp
# distance of (a payload's beta, a verdict's beta); K-SQS is byte-equal
ULPS = {"csqs": [(1, 0), (0, 0), (1, 0)]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = st.torch.get_num_threads()
    st.torch.set_num_threads(1)
    yield
    st.torch.set_num_threads(n)


@pytest.mark.parametrize("method", ["ksqs", "csqs"])
def test_engine_matches_reference(method):
    st.check_engine_matches_reference(ARCH, method, ULPS)


@pytest.mark.parametrize("self_draft", [False, True],
                         ids=["bridged-pair", "self-draft"])
def test_rollback_matches_prefill_of_verified_prefix(self_draft):
    st.check_rollback_matches_prefill(ARCH, self_draft)


def test_lockstep_trace_with_slot_reuse_matches_reference():
    st.serve_both(ARCH)


def test_paged_trace_matches_dense_and_reference():
    rep = st.serve_both(ARCH, page_size=8)
    assert st.streams(rep) == st.port_serve(ARCH)
    assert rep.peak_pages_in_use > 0
    # only the attention layers live in the page pool
    _, (_, _, _, tm) = st.pair(ARCH)
    cache = st.tmodel.init_cache(tm, 2, 32, paged=PagedSpec(
        page_size=8, n_pages=8, max_pages_per_slot=4))
    assert ["page_table" in c for c in cache] == \
        [blk.block_type == "attn" for blk in tm.layers]
