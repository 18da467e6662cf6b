"""The pack kernel's cost by its own formula: the input read once, the
blocks and scales written once, and about 8 fp32 operations an element
(|x|, max, x/scale, round, two clamps, convert; one division a block).
``chip_smoke.py``'s bound and the op counter of the dry run
(``launch.op_analysis``) both read it."""
from __future__ import annotations


def pack_cost(x, blocks, scales) -> dict:
    """-> {"flops", "bytes"} of one quantizing pack of ``x``."""
    return {"flops": 8 * x.numel(),
            "bytes": sum(t.numel() * t.element_size() for t in (x, blocks, scales))}
