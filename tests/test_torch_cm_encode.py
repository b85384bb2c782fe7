"""The port's CM lane encoder against the reference ``ArenaEncoder`` (JAX on
the CPU, driven as tests/test_codec_arena.py drives it) and against the
native engine's coded segments, with lanes of mixed lengths. The codec has
no floating point: every comparison is exact. On the CPU the wrapper runs
the plain PyTorch version; the CUDA kernel is held against it in
tests/test_torch_card.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zpaqfranz_tpu import native as ref_native
from zpaqfranz_tpu.codec.methods import make_model as ref_make_model
from zpaqfranz_tpu.ops.codec_arena import ArenaEncoder
from zpaqfranz_tpu.parallel import engine as ref_engine
from zpaqfranz_tpu.zpaql.compiler import compile_config as ref_compile

from zpaqfranz_tpu_torch import convert
from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme
from zpaqfranz_tpu_torch.parallel.engine import parse_block_payload

from test_codec_arena import ALL_COMPONENTS_CFG

# lane payload lengths: mixed, so lanes reach their last byte at different
# bytes of the batch
LENGTHS = {"3": (0, 17, 64, 111), "4.0": (5, 30, 58), "5.0": (3, 18, 41),
           "cfg": (9, 33, 80)}


def _ref_model(method):
    if method == "cfg":
        return ref_compile(ALL_COMPONENTS_CFG)[0], None
    return ref_make_model(method)


@functools.lru_cache(maxsize=None)
def _lanes(method):
    """(port model, lane payloads with their selector prefix, the native
    engine's coded segment bodies of the same payloads): the reference
    add's preprocessed payloads (BWT at -m3) of seeded text and noise."""
    ref, pre = _ref_model(method)
    model = convert.model_from_reference_header(ref.header_bytes())
    blob = ref.pcomp_bytes()
    prefix = (b"\x01" + blob) if blob else b"\x00"
    rng = np.random.default_rng(len(method))
    text = b"abcabcabc the CAT sat on the mat; it sat and sat. 123\n" * 4
    pays = []
    for n in LENGTHS[method]:
        cut = int(rng.integers(0, 40))
        raw = (text[cut:cut + n - n // 5]
               + rng.integers(0, 256, n // 5, dtype=np.uint8).tobytes())[:n]
        pays.append(raw if pre is None
                    else ref_engine.prepare_payload(pre, raw)[0])
    coded = [parse_block_payload(ref_native.compress_block(ref, p, b"t", b"c"),
                                 0)[2][:-6] for p in pays]
    return model, [prefix + p for p in pays], coded


def _encode(model, payloads):
    return cmd.lanes_to_bytes(*cme.cm_encode(
        model, *cme.pack_payloads(payloads, "cpu")))


@pytest.mark.parametrize("method", ["3", "4.0", "5.0", "cfg"])
def test_plain_matches_reference_arena_and_native(method):
    model, pays, coded = _lanes(method)
    before = cme.launches
    got = _encode(model, pays)
    assert got == coded
    assert cme.launches == before      # the CPU ran the plain version

    # the reference device encoder on the same lanes (JAX on the CPU)
    width = max(map(len, pays))
    data = np.zeros((len(pays), width), np.uint8)
    for i, p in enumerate(pays):
        data[i, :len(p)] = np.frombuffer(p, np.uint8)
    enc = ArenaEncoder(_ref_model(method)[0], out_cap=2 * width + 64)
    st = jax.jit(enc.encode)(jnp.asarray(data), jnp.asarray(
        np.array([len(p) for p in pays], np.int32)))
    out, cnt = np.asarray(st["out"]), np.asarray(st["cnt"])
    assert [bytes(out[i, :cnt[i]]) for i in range(len(pays))] == got


def test_plain_round_trips_through_plain_decode():
    model, pays, coded = _lanes("cfg")
    streams = [c + b"\x00\x00\x00\x00" for c in _encode(model, pays)]
    back = cmd.lanes_to_bytes(*cmd.cm_decode(model, *cmd.pack_streams(
        streams, [len(p) for p in pays], "cpu")))
    assert back == pays


def test_lanes_per_launch_do_not_interact():
    # each lane coded alone equals the same lane inside the batch
    model, pays, coded = _lanes("3")
    for p, c in zip(pays, coded):
        assert _encode(model, [p]) == [c]


def test_overrun_raises_instead_of_truncating():
    model, pays, coded = _lanes("3")
    data, off, ln, cap = cme.pack_payloads(pays, "cpu")
    assert cap.tolist() == [len(p) + len(p) // 2 + 64 for p in pays]
    cap[2] = len(coded[2]) - 1
    with pytest.raises(cme.CMEncodeError, match="lane 2: coded past"):
        cme.cm_encode(model, data, off, ln, cap)
    cap[2] = len(coded[2])
    assert cmd.lanes_to_bytes(*cme.cm_encode(model, data, off, ln, cap)) \
        == coded


def test_wrapper_rejects_bad_inputs():
    model, pays, _ = _lanes("3")
    data, off, ln, cap = cme.pack_payloads(pays, "cpu")
    with pytest.raises(TypeError):
        cme.cm_encode(model, data.long(), off, ln, cap)
    with pytest.raises(TypeError):
        cme.cm_encode(model, data, off.int(), ln, cap)
    with pytest.raises(ValueError):
        cme.cm_encode(model, data, off, ln[:2], cap)
    with pytest.raises(ValueError):
        cme.cm_encode(model, data, off, ln, torch.flip(cap, (0,))[::2])
    store = convert.model_from_reference_header(
        ref_compile("comp 0 0 0 0 0\nhcomp\n  halt\npost 0 end\n")[0]
        .header_bytes())
    with pytest.raises(ValueError):
        cme.cm_encode(store, data, off, ln, cap)
