"""The port's device BWT (``pre/bwt_device.py``, prefix doubling over
``torch.sort``) against the reference's (JAX on the CPU) and the native
SA-IS engine, on the CPU: the same stream bytes, the same suffix array, and
the stream inverts through the -m3 inverse-BWT postprocessor. Its run on the
card is in ``tests/test_torch_card.py``."""

import numpy as np
import pytest
import torch

from zpaqfranz_tpu import native as ref_native
from zpaqfranz_tpu.pre import bwt_device as ref_bwt

from zpaqfranz_tpu_torch import native
from zpaqfranz_tpu_torch.codec.methods import make_model
from zpaqfranz_tpu_torch.pre import bwt_device as bwt


def _case(name):
    rng = np.random.default_rng(29)
    return {"empty": b"", "one": b"q", "two": b"ba",
            "255": rng.integers(0, 256, 255, dtype=np.uint8).tobytes(),
            "rep4k": (b"the quick brown fox " * 300)[:4096],
            "rand64k": rng.integers(0, 256, 64 << 10,
                                    dtype=np.uint8).tobytes(),
            "zeros": bytes(1000)}[name]


def _inverse(stream, n):
    model, _ = make_model("3")
    return native.postprocess(model.ph, model.pm,
                              b"\x01" + model.pcomp_bytes() + stream,
                              out_hint=n)


@pytest.mark.parametrize("name", ["empty", "one", "two", "255", "rep4k",
                                  "rand64k", "zeros"])
def test_bwt_matches_reference_and_native(name):
    data = _case(name)
    got = bwt.bwt_encode_device(data, device="cpu")
    assert got == native.bwt_encode(data) == ref_native.bwt_encode(data)
    assert got == ref_bwt.bwt_encode_device(data)
    assert _inverse(got, len(data)) == data


@pytest.mark.parametrize("name", ["empty", "one", "two", "255", "rep4k",
                                  "rand64k"])
def test_suffix_array_matches_reference(name):
    data = _case(name)
    got = bwt.suffix_array_device(data, device="cpu")
    assert got.dtype == np.int32
    assert np.array_equal(got, ref_bwt.suffix_array_device(data))
    suf = [data[i:] for i in got[:200]]
    assert suf == sorted(suf)


def test_prefix_doubling_stops_when_ranks_are_distinct(monkeypatch):
    """Distinct bytes: one round sorts them all; a repetitive string takes
    about log2 of its longest repeat."""
    sorts = []
    sort = torch.sort

    def counted(keys, **kw):
        sorts.append(keys.numel())
        return sort(keys, **kw)

    monkeypatch.setattr(torch, "sort", counted)
    sa, rounds = bwt.prefix_doubling(
        torch.arange(200, dtype=torch.uint8).flip(0))
    monkeypatch.undo()
    assert rounds == 1 and len(sorts) == 2
    assert sa.tolist() == list(range(199, -1, -1))
    sa, rounds = bwt.prefix_doubling(torch.zeros(1000, dtype=torch.uint8))
    assert rounds == 10 and sa.tolist() == list(range(999, -1, -1))
