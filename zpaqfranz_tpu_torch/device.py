"""Which device the port's lane kernels run on.

``None`` means the CUDA card. There is no deadline and no fallback: a
caller who wants the plain PyTorch versions asks for ``"cpu"``, and one who
wants the host engine passes ``use_device=False`` to the archive functions
(``None`` there asks the engine gate, ``device_policy.py``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Union

import torch


class NoDeviceError(RuntimeError):
    pass


def resolve(device: Optional[Union[str, torch.device]] = None
            ) -> torch.device:
    """The torch device for the lane kernels; raises ``NoDeviceError`` when
    the card is asked for (explicitly or by ``None``) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoDeviceError(
                "no CUDA device: pass device='cpu' for the plain versions, "
                "or use_device=False (-notpu) for the host engine")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def seconds(fn: Callable, *args, reps: int = 5) -> float:
    """Seconds per call of ``fn(*args)``, on the device of its first tensor
    argument: on the card the mean of ``reps`` calls timed with CUDA events
    after a warm-up call, on the CPU the best of ``reps`` after a warm-up
    call."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn(*args)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps / 1e3
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best
