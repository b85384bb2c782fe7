"""The port's batched-coder API (``ops/coder_batched.py``,
``ops/predictor_batched.py``) against the reference's ``coder_batched``
(JAX on the CPU) and the scalar writer (``codec/writer.py``): the same
decoded bytes and the same coded streams, exactly, through the CM lane
coders' plain versions on the CPU (the card's kernels in
``tests/test_torch_card.py``). The reference's jit compiles take 5-25 s a
model, so only the small config meets it; the four-component config meets
the scalar writer."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from zpaqfranz_tpu.ops import coder_batched as ref_cb
from zpaqfranz_tpu.zpaql.compiler import compile_config as ref_compile

from zpaqfranz_tpu_torch.codec.container import (ByteReader, find_block,
                                                 read_comment, read_filename)
from zpaqfranz_tpu_torch.codec.writer import Encoder, compress_block
from zpaqfranz_tpu_torch.device import NoDeviceError
from zpaqfranz_tpu_torch.models.predictor import Predictor
from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme
from zpaqfranz_tpu_torch.ops.coder_batched import (BatchedDecoder,
                                                   BatchedEncoder)
from zpaqfranz_tpu_torch.ops.predictor_batched import BatchedPredictor
from zpaqfranz_tpu_torch.zpaql.compiler import compile_config

CM_CFG = "comp 1 0 0 0 1  0 cm 12 7  hcomp a<<= 8 *d=a halt post 0 end"

MID8_CFG = """
comp 2 2 0 0 4
  0 icm 5
  1 isse 12 0
  2 match 14 16
  3 mix 8 0 3 24 255
hcomp
  c++ *c=a b=c a=0
  d= 1 hash *d=a
  b-- d++ hash *d=a
  d++ a=*c a<<= 8 *d=a
  halt
post 0 end
"""


def _payloads():
    rng = np.random.default_rng(42)
    return [b"abracadabra " * 20,
            rng.integers(0, 256, 150, dtype=np.uint8).tobytes(),
            b"the quick brown fox " * 12,
            bytes(100)]


def _coded(payloads, model):
    """Each payload's scalar-written block: the bytes after the segment
    header (coded data and tail)."""
    streams = []
    for pl in payloads:
        arc = bytes(compress_block(pl, model))
        r = ByteReader(arc)
        find_block(r)
        read_filename(r)
        read_comment(r)
        streams.append(arc[r.pos:])
    return streams


def _scalar_bodies(payloads, model):
    out = []
    for pl in payloads:
        body = bytearray()
        enc = Encoder(Predictor(model), body)
        for c in [0, *pl, -1]:
            enc.compress(c)
        out.append(bytes(body))
    return out


def _rows(lanes):
    rows = np.zeros((len(lanes), max(map(len, lanes))), np.uint8)
    for i, s in enumerate(lanes):
        rows[i, :len(s)] = np.frombuffer(s, np.uint8)
    return rows


def test_decode_and_encode_match_the_reference():
    model, ref_model = compile_config(CM_CFG)[0], ref_compile(CM_CFG)[0]
    payloads = _payloads()
    data = _rows(_coded(payloads, model))
    max_bytes = max(map(len, payloads)) + 1
    before = cmd.launches
    out, lens = BatchedDecoder(model, device="cpu").decode(data, max_bytes)
    assert cmd.launches == before          # the plain decoder on the CPU
    want, want_lens, _ = jax.jit(lambda d: ref_cb.BatchedDecoder(
        ref_model).decode(d, max_bytes))(jnp.asarray(data))
    assert np.array_equal(lens, np.asarray(want_lens))
    assert np.array_equal(out, np.asarray(want))
    assert [bytes(out[i, 1:lens[i]]) for i in range(len(payloads))] == \
        payloads

    streams = _rows([b"\x00" + p for p in payloads])
    slen = np.array([len(p) + 1 for p in payloads], np.int32)
    cap = streams.shape[1] + 64
    got, cnt = BatchedEncoder(model, out_cap=cap, device="cpu").encode(
        streams, slen)
    st = jax.jit(ref_cb.BatchedEncoder(ref_model, out_cap=cap).encode)(
        jnp.asarray(streams), jnp.asarray(slen))
    assert np.array_equal(cnt, np.asarray(st["enc"].cnt))
    assert np.array_equal(got, np.asarray(st["enc"].out))
    assert [bytes(got[i, :cnt[i]]) for i in range(len(payloads))] == \
        _scalar_bodies(payloads, model)


def test_four_components_match_the_scalar_writer():
    model = compile_config(MID8_CFG)[0]
    payloads = _payloads()
    out, lens = BatchedDecoder(model, device="cpu").decode(
        torch.from_numpy(_rows(_coded(payloads, model))), 250)
    assert out.shape == (4, 250) and lens.dtype == np.int32
    assert [bytes(out[i, :lens[i]]) for i in range(4)] == [
        b"\x00" + p for p in payloads]
    before = cme.launches
    got, cnt = BatchedEncoder(model, device="cpu").encode(
        _rows([b"\x00" + p for p in payloads]),
        [len(p) + 1 for p in payloads])
    assert cme.launches == before
    assert [bytes(got[i, :cnt[i]]) for i in range(4)] == \
        _scalar_bodies(payloads, model)


def test_a_lane_past_its_capacity_raises():
    model = compile_config(CM_CFG)[0]
    payloads = _payloads()
    with pytest.raises(cmd.CMDecodeError):
        BatchedDecoder(model, device="cpu").decode(
            _rows(_coded(payloads, model)), 50)
    with pytest.raises(cme.CMEncodeError):
        BatchedEncoder(model, out_cap=20, device="cpu").encode(
            _rows(payloads), [len(p) for p in payloads])


def test_predictor_per_bit_equals_the_scalar_predictor():
    """``BatchedPredictor`` over three lanes in lockstep gives each lane the
    scalar predictor's probability at every bit."""
    model = compile_config(MID8_CFG)[0]
    lanes = [b"abcabcabcabd", bytes(range(12)), b"zzzzzzzzzzzz"]
    bp = BatchedPredictor(model)
    st = bp.init_state(len(lanes), device="cpu")
    scalars = [Predictor(model) for _ in lanes]
    for j in range(len(lanes[0])):
        for phase in range(8):
            p_final, p, st = bp.predict(st, phase)
            assert p_final.tolist() == [s.predict() for s in scalars]
            y = [(lane[j] >> (7 - phase)) & 1 for lane in lanes]
            st = bp.update(st, p, torch.tensor(y), phase)
            for s, b in zip(scalars, y):
                s.update(b)
    with pytest.raises(ValueError):
        bp.init_state(2, device="meta")


def test_predictor_runs_on_the_card_by_default():
    """With no device ``init_state`` asks for the card: without one it
    raises, with one the lanes' state lies there."""
    bp = BatchedPredictor(compile_config(CM_CFG)[0])
    if torch.cuda.is_available():
        assert bp.init_state(2).dev.type == "cuda"
    else:
        with pytest.raises(NoDeviceError):
            bp.init_state(2)
