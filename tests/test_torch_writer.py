"""The port's scalar block writer (``codec/writer.py``) against the
reference's: the same data through the same model give identical bytes at
the -m1..-m5 models and a small config, and the port's own container reads
each block back. The scalar coder runs at ~1 KB/s, so inputs stay small."""

import numpy as np
import pytest

from zpaqfranz_tpu.codec import writer as ref_writer
from zpaqfranz_tpu.codec.methods import make_model as ref_make_model
from zpaqfranz_tpu.zpaql.compiler import compile_config as ref_compile

from zpaqfranz_tpu_torch.codec import writer
from zpaqfranz_tpu_torch.codec.container import decompress_stream
from zpaqfranz_tpu_torch.codec.methods import make_model
from zpaqfranz_tpu_torch.models.predictor import Predictor
from zpaqfranz_tpu_torch.zpaql.compiler import compile_config

CFG = "comp 1 0 0 0 1  0 cm 12 7  hcomp a<<= 8 *d=a halt post 0 end"


def _models(method):
    if method == "cfg":
        return ref_compile(CFG)[0], compile_config(CFG)[0]
    return ref_make_model(method)[0], make_model(method)[0]


def _data(n):
    rng = np.random.default_rng(n)
    text = b"the writer codes the same bits as the reference "
    return (text * 8)[:n // 2] + rng.integers(0, 256, n - n // 2,
                                              dtype=np.uint8).tobytes()


@pytest.mark.parametrize("method,n", [("1", 3000), ("2", 3000), ("3", 300),
                                      ("4", 200), ("5", 120), ("cfg", 600)])
def test_writer_bytes_equal_the_reference(method, n):
    ref_model, model = _models(method)
    data = _data(n)
    got = writer.compress_block(data, model, b"name", b"comment")
    want = ref_writer.compress_block(data, ref_model, b"name", b"comment")
    assert bytes(got) == bytes(want)
    if model.pcomp_bytes() is None:
        seg = decompress_stream(bytes(got))[0].segments[0]
        assert seg.data == data and seg.filename == b"name"


def test_encoder_stream_equals_the_reference():
    """The bare coder: selector, bytes and end of segment, no framing."""
    ref_model, model = _models("4")
    data = _data(150)
    got, want = bytearray(), bytearray()
    for mod, m, out in ((writer, model, got), (ref_writer, ref_model, want)):
        enc = mod.Encoder(mod.Predictor(m), out)
        for c in [0, *data, -1]:
            enc.compress(c)
    assert got == want and len(got) > 0
    assert writer.Predictor is Predictor
