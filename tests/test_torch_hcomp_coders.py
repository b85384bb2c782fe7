"""The port's plain CM coders with the specialised HCOMP step (the torch
executor of ``zpaqfranz_tpu_torch/ops/hcomp_fast.py``) against the
reference ``ArenaEncoder`` (JAX on the CPU, which runs the reference
``FastHcomp``) at -m3, -m4 and -m5 at their own block widths: the same
coded streams bit for bit, decoded back to the payloads, and the same
segments as the native engine's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zpaqfranz_tpu import native as ref_native
from zpaqfranz_tpu.codec.methods import make_model as ref_make_model
from zpaqfranz_tpu.ops.codec_arena import ArenaEncoder
from zpaqfranz_tpu.parallel import engine as ref_engine

from zpaqfranz_tpu_torch import convert
from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme
from zpaqfranz_tpu_torch.ops.cm_model import PlainModel
from zpaqfranz_tpu_torch.parallel.engine import parse_block_payload

# two lanes a level: text with a word model's branches, and a short mix
RAWS = (b"The Cat sat on the MAT; it sat and sat, 12345 times.\n" * 3,
        b"zpaq \x00\x01\x02 lanes " * 3)


@pytest.mark.parametrize("method", ["3", "4", "5"])
def test_plain_coders_with_specialised_step_match_reference(method):
    ref, pre = ref_make_model(method)
    model = convert.model_from_reference_header(ref.header_bytes())
    assert PlainModel(model, 1, "cpu").fh is not None
    blob = ref.pcomp_bytes()
    prefix = (b"\x01" + blob) if blob else b"\x00"
    pays = [prefix + (r if pre is None
                      else ref_engine.prepare_payload(pre, r)[0])
            for r in RAWS]
    got = cmd.lanes_to_bytes(*cme.cm_encode(
        model, *cme.pack_payloads(pays, "cpu")))

    width = max(map(len, pays))
    data = np.zeros((len(pays), width), np.uint8)
    for i, p in enumerate(pays):
        data[i, :len(p)] = np.frombuffer(p, np.uint8)
    enc = ArenaEncoder(ref, out_cap=2 * width + 64)
    st = jax.jit(enc.encode)(jnp.asarray(data), jnp.asarray(
        np.array([len(p) for p in pays], np.int32)))
    out, cnt = np.asarray(st["out"]), np.asarray(st["cnt"])
    assert got == [bytes(out[i, :cnt[i]]) for i in range(len(pays))]
    assert got == [parse_block_payload(
        ref_native.compress_block(ref, p[len(prefix):], b"t", b"c"),
        0)[2][:-6] for p in pays]

    streams = [c + b"\x00\x00\x00\x00" for c in got]
    back = cmd.lanes_to_bytes(*cmd.cm_decode(model, *cmd.pack_streams(
        streams, [len(p) for p in pays], "cpu")))
    assert back == pays
