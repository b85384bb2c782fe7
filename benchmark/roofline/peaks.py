"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), the card's full
700 W power limit.

- ``HBM_BYTES_PER_S``: 3.35 TB/s, NVIDIA's H100 SXM data sheet.
- ``INT32_OPS_PER_S``: 132 SMs x 64 INT32 lanes a clock x 1.98 GHz (the
  boost clock), from the Hopper architecture white paper's SM figures:
  16.7 Tops/s.
"""

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound_seconds(operations: float, nbytes: float) -> float:
    """The least time the work can take: the larger of its operations over
    the integer peak and its bytes over the memory bandwidth."""
    return max(operations / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
