"""The benchmark's CPU tests. They import no JAX; a test that needs the
card carries the ``cuda`` marker and skips inside itself without one."""

import dataclasses
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def port_on_cpu(monkeypatch):
    """The CLI's ``-tpu`` runs the port's plain PyTorch versions on the
    CPU. Not the benchmark: a run there times nothing of the card."""
    import zpaqfranz_tpu_torch.device as zd
    orig = zd.resolve
    monkeypatch.setattr(zd, "resolve",
                        lambda device=None: orig("cpu" if device is None
                                                 else device))


@pytest.fixture
def small_blocks(monkeypatch):
    """256-byte d blocks, so a tiny tree makes several lanes a launch."""
    from zpaqfranz_tpu_torch.jidac import add
    orig = add.make_model

    def make(method):
        model, pre = orig(method)
        return model, dataclasses.replace(pre, block_bits=8)
    monkeypatch.setattr(add, "make_model", make)
