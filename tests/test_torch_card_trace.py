"""The CM kernels' lane stamps on the card: a stamped launch codes the
bytes an unstamped one does, and the tracer's span ``cm.wait`` carries
the lanes' nanoseconds. Held against the port's own native engine; this
file imports nothing of the JAX package. Skips without a CUDA card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_card_trace.py
"""

import pytest
import torch

from zpaqfranz_tpu_torch import trace
from zpaqfranz_tpu_torch.codec.methods import make_model
from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme
from zpaqfranz_tpu_torch.ops.cm_model import Placement, lane_bytes
from zpaqfranz_tpu_torch.parallel.engine import coded_stream, selector

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("method", ["3", "4.0"])
def test_cm_lane_stamps_change_no_byte(card, method):
    """A launch of the same lanes (one more than a block holds) outside
    the profiler and one inside it, which stamps, code and decode the
    same bytes as the native engine; every stamped lane starts at or
    before its end. Under the profiler ``cm_encode``'s span ``cm.wait``
    holds each lane's nanoseconds and the launch's."""
    from torch.profiler import ProfilerActivity, profile

    def run(launch, args, stamped):
        if not stamped:
            return launch(model, *args).run()
        with profile(activities=[ProfilerActivity.CPU]):
            return launch(model, *args).run()

    model = make_model(method)[0]
    L = Placement(model).lanes_per_block + 1
    raws = [b"lane %d: " % k + b"the cat sat on the mat " * (k % 4)
            for k in range(L)]
    prefix = selector(model)
    coded = [coded_stream(model, r) for r in raws]
    packed = cme.pack_payloads([prefix + r for r in raws], card)
    streams = cmd.pack_streams(coded, [len(prefix) + len(r) + 64
                                       for r in raws], card)
    for launch, args, want in ((cme.Launch, packed, [c[:-6] for c in coded]),
                               (cmd.Launch, streams,
                                [prefix + r for r in raws])):
        runs = [run(launch, args, s) for s in (False, True)]
        got = [cmd.lanes_to_bytes(*r.result()) for r in runs]
        assert got[0] == got[1] == want
        assert runs[0].stamps is None
        ns = runs[1].stamps.cpu()
        assert ns.shape == (L, 2) and bool((ns[:, 0] > 0).all())
        assert bool((ns[:, 0] <= ns[:, 1]).all())
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            got = cmd.lanes_to_bytes(*cme.cm_encode(model, *packed))
        recs = {r.name: r for r in trace.records()}
    finally:
        trace.clear()
    assert got == [c[:-6] for c in coded]
    assert recs["cm.launch"].counts["lanes"] == L
    assert recs["cm.launch"].counts["combine"] == "fast"
    assert recs["cm.launch"].counts["phases"] == "fast"
    wait = recs["cm.wait"].counts
    assert len(wait["lane_ns"]) == L
    assert 0 < max(wait["lane_ns"]) <= wait["kernel_ns"]


@pytest.mark.parametrize("method", ["3", "4.0", "5.0"])
def test_cm_spans_count_lane_state_and_bits(card, method):
    """A traced encode of one more lane than a block holds: ``cm.launch``
    counts the lanes' state on the card, L x ``lane_bytes`` of the
    specialised step, and ``cm.wait`` one ``lane_bits`` a lane, 8 x its
    payload; an untraced launch records nothing and does not stamp."""
    from torch.profiler import ProfilerActivity, profile

    model = make_model(method)[0]
    L = Placement(model).lanes_per_block + 1
    pays = [selector(model) + b"lane %d: " % k
            + b"the cat sat on the mat " * (k % 5) for k in range(L)]
    packed = cme.pack_payloads(pays, card)
    want = [c[:-6] for c in (coded_stream(model, p[len(selector(model)):])
                             for p in pays)]
    trace.clear()
    try:
        assert cmd.lanes_to_bytes(*cme.cm_encode(model, *packed)) == want
        assert trace.records() == []
        with profile(activities=[ProfilerActivity.CPU]):
            got = cmd.lanes_to_bytes(*cme.cm_encode(model, *packed))
        recs = {r.name: r for r in trace.records()}
    finally:
        trace.clear()
    assert got == want
    launch = recs["cm.launch"].counts
    assert launch["hcomp"] == "fast"
    assert launch["state_bytes"] == L * lane_bytes(model, "fast")
    wait = recs["cm.wait"].counts
    assert len(wait["lane_bits"]) == len(wait["lane_ns"]) == L
    assert wait["lane_bits"] == [8 * len(p) for p in pays]
