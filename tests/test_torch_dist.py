"""Lanes split over several devices: the port's sharded coders against the
reference's, on the CPU. The port's shards run on ``["cpu"] * k`` through
the CM coders' plain versions; the reference shards over JAX's eight CPU
devices (tests/conftest.py). The coded bytes must be exact: the archive's
bytes may not depend on the number of devices."""

import pytest
import torch

from zpaqfranz_tpu.codec.methods import make_model as ref_make_model
from zpaqfranz_tpu.parallel import dist as ref_dist

from zpaqfranz_tpu_torch.codec.methods import make_model
from zpaqfranz_tpu_torch.device import NoDeviceError
from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme
from zpaqfranz_tpu_torch.parallel import dist

_METHOD = "x4.0ci1"
MAX_OUT = 1 + 25 * 30 + 8             # a payload and 8 bytes to spare


def _payloads():
    return [b"\x00" + (b"shard me over the mesh %d " % i) * 30
            for i in range(6)]


@pytest.fixture(scope="module")
def reference_coded():
    model, _ = ref_make_model(_METHOD)
    return ref_dist.encode_streams_sharded(model, _payloads(),
                                           ref_dist.default_mesh(8))


@pytest.mark.parametrize("k,spans", [
    (1, [(0, 6)]), (2, [(0, 3), (3, 6)]), (4, [(0, 2), (2, 4), (4, 6)]),
    (8, [(k, k + 1) for k in range(6)])])
def test_contiguous_split_launches_no_empty_shard(k, spans):
    parts = dist._shards(["cpu"] * k, 6)
    assert [(s, e) for _d, s, e in parts] == spans
    assert all(d == torch.device("cpu") for d, _s, _e in parts)
    assert dist._shards(["cpu"] * k, 0) == []


@pytest.mark.parametrize("k", [2, 8])
def test_sharded_encode_equals_reference(reference_coded, k):
    """At k = 8 two of the devices get no lane."""
    model, _ = make_model(_METHOD)
    before = cme.launches
    assert dist.encode_streams_sharded(model, _payloads(),
                                       ["cpu"] * k) == reference_coded
    assert cme.launches == before           # the plain version ran


@pytest.fixture(scope="module")
def decoded(reference_coded):
    """The reference's coded lanes decoded over two devices."""
    model, _ = make_model(_METHOD)
    before = cmd.launches
    out = dist.decode_streams_sharded(model, reference_coded, MAX_OUT,
                                      ["cpu", torch.device("cpu")])
    assert cmd.launches == before           # the plain version ran
    return out


def test_sharded_decode_round_trip(decoded):
    assert decoded == _payloads()


def test_chunked_entry_equals_unchunked(reference_coded, decoded):
    model, _ = make_model(_METHOD)
    assert dist.decode_streams_sharded_chunked(
        model, reference_coded, MAX_OUT, ["cpu"] * 2, chunk=16) == decoded


def test_default_mesh_is_the_cards():
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert dist.default_mesh() == [torch.device("cuda", i)
                                       for i in range(n)]
        assert dist.default_mesh(1) == [torch.device("cuda", 0)]
        with pytest.raises(ValueError):
            dist.default_mesh(n + 1)
    else:
        with pytest.raises(NoDeviceError):
            dist.default_mesh()
        # no mesh means the cards: none here, so it raises, not falls back
        model, _ = make_model(_METHOD)
        with pytest.raises(NoDeviceError):
            dist.encode_streams_sharded(model, _payloads())
        with pytest.raises(NoDeviceError):
            dist.decode_streams_sharded(model, [b"x"], 8, ["cuda:0"])
