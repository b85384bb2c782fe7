"""-method 5.0 d blocks (zpaqfranz's maximum level, ``a -m5``: 23
components, a direct CM, sparse and skip contexts, a 19-bit SSE) on the
add path, held to the benchmark's reference: a seeded tree of the
``m5_b1.add`` traffic's data classes, cut to ~2 MB, coded by the host
engine and by the card path's launch code on the CPU (each lane coded by
the native engine under ``cm_encode_plain``'s contract) into the same
archive, whose every d block carries ``make_model("5.0")``'s header, the
configuration's ``header_hex``, and decodes in the benchmark's own
decoder (``benchmark/reference/zpaqd.c``) to the tree's bytes."""

import json
import pathlib

import pytest
import torch

from benchmark import treegen
from benchmark.reference import archive as barc
from benchmark.reference.codec import Decoder
from zpaqfranz_tpu_torch.codec.methods import make_model
from zpaqfranz_tpu_torch.jidac import add as port_add
from zpaqfranz_tpu_torch.ops import cm_encode as cme

from test_torch_bwt_jobs import _native_lanes

DATE = 20260102030405
BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "m5_b1.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "m5_b1.add.json").read_text())
TREE_BYTES = 2_000_000


def _tree(root: pathlib.Path, seed: int):
    """One round of the traffic's file list scaled to ~``TREE_BYTES``,
    with its whole-file copies; the files' names under ``root``."""
    corpus = sum(size for _, _, size in TRAFFIC["files"])
    files = [[name, kind, max(1, size * TREE_BYTES // corpus)]
             for name, kind, size in TRAFFIC["files"]]
    shape = dict(TRAFFIC, files=files,
                 tree_bytes=sum(size for _, _, size in files))
    specs = treegen.write_tree(shape, seed, root, torch.device("cpu"))
    return [s.name for s in specs]


def test_m5_config_is_the_level_5_preset():
    """The cell's configuration states the model ``make_model("5.0")``
    builds: its 23 components and its header, CM and SSE among them."""
    model = make_model(CONFIG["method"])[0]
    assert CONFIG["switches"][:2] == ["-method", "5.0"]
    assert [list(c) for c in model.comps] == CONFIG["components"]
    assert model.header_bytes().hex() == CONFIG["header_hex"]
    assert model.n == 23
    control = make_model(CONFIG["control"]["switches"][1])[0]
    assert control.header_bytes() != model.header_bytes()


@pytest.mark.parametrize("seed", [2_718_281_828])
def test_m5_card_path_writes_the_host_bytes_that_the_reference_decodes(
        tmp_path, monkeypatch, seed):
    monkeypatch.chdir(tmp_path)
    names = _tree(tmp_path / "tree", seed)
    port_add.add("h.zpaq", ["tree"], method="5.0", date=DATE,
                 use_device=False)
    monkeypatch.setattr(cme, "cm_encode_plain", _native_lanes)
    port_add.add("d.zpaq", ["tree"], method="5.0", date=DATE,
                 use_device=True, device="cpu")
    buf = pathlib.Path("h.zpaq").read_bytes()
    assert pathlib.Path("d.zpaq").read_bytes() == buf
    arc = barc.read_archive(buf)
    tc = barc.check_tree(arc, tmp_path / "tree", names, "tree/")
    assert tc.files_wrong == tc.fragments_wrong == 0
    header = bytes.fromhex(CONFIG["header_hex"])
    assert header == make_model("5.0")[0].header_bytes()
    assert barc.check_headers(buf, arc, [header]) == 0
    assert len(arc.blocks) >= 2
    decoder = Decoder(tmp_path / "zpaqd")
    assert barc.check_blocks(buf, arc, tmp_path / "tree", tc.where,
                             range(len(arc.blocks)), decoder,
                             len(arc.blocks)) == 0
