"""CM encode of many lanes: every payload byte is 8 coded bits through the
configuration's model (``cm_components``); bytes: each payload byte read
once, each coded byte written once."""

from . import cm_components

#: the kernel's name in the profiler's trace, and the span that records
#: the work of its launches
KERNEL = "cm_encode_kernel"
SPAN = "encode_streams"


def work(launches, config) -> tuple:
    """``launches``: each a dict with ``in_bytes`` (payload bytes per lane)
    and ``out_bytes`` (coded bytes per lane)."""
    per_bit = cm_components.ops_per_bit(config["components"])
    n_in = sum(sum(x["in_bytes"]) for x in launches)
    n_out = sum(sum(x["out_bytes"]) for x in launches)
    return 8 * n_in * per_bit, n_in + n_out
