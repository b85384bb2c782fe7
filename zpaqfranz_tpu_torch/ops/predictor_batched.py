"""The batched ZPAQ predictor, per bit: L streams in lockstep.

The port of ``zpaqfranz_tpu/ops/predictor_batched.py``'s API. The
reference's ``BatchedPredictor`` is a second device engine, one jnp table
operation at a time (``ZPAQFRANZ_DEVICE_ENGINE=batched``) beside the arena
engine, with identical results. The port has one CM model: the CUDA lane
kernels fuse the whole predict, code and update chain of a lane
(``BatchedDecoder`` / ``BatchedEncoder`` in ``ops/coder_batched.py``), and
there is no kernel for a single prediction. So ``BatchedPredictor`` is the
per-bit face of the kernels' plain version, ``ops/cm_model.PlainModel``,
whose torch ops run on the card unless the caller asks for ``"cpu"``.

Lanes run in lockstep: every lane is at the same bit of its byte, and
``predict`` and ``update`` step all of them (the reference's ``active``
mask has no counterpart; a caller drops the lanes it has finished).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..device import resolve
from ..zpaql.header import Model
from .cm_model import PlainModel

__all__ = ["BatchedPredictor"]


class BatchedPredictor:
    """``init_state(L)`` -> the lanes' state; per bit, at ``phase`` 0..7
    (the bit's index in its byte, from the top), ``predict`` gives each
    lane's P(1) in 1/4096 units and ``update`` trains the model on the bit
    and, after phase 7, runs HCOMP on the byte. The reference's signatures:
    the state is returned, and ``update`` takes ``predict``'s component
    outputs, which the state here already holds."""

    def __init__(self, model: Model):
        if model.n == 0:
            raise ValueError("store-mode blocks have no predictor")
        self.model = model

    def init_state(self, n_lanes: int, device=None) -> PlainModel:
        return PlainModel(self.model, n_lanes, resolve(device))

    def predict(self, st: PlainModel, phase: int
                ) -> Tuple[torch.Tensor, List[torch.Tensor], PlainModel]:
        """(p_final (L,) int64 in 0..4095, every component's output, st)."""
        return st.predict(phase), list(st.p), st

    def update(self, st: PlainModel, p: List[torch.Tensor], y, phase: int
               ) -> PlainModel:
        st.update(phase, torch.as_tensor(y, device=st.dev).long())
        return st
