"""Peaks of the chip and the least time of the ACFF block's work.

Frozen copies: ``acff_bound`` is the ``bound`` of ``chip_smoke.py``
(route "bf16"), with ``padded_k`` of ``rtdm_tpu_torch/ops/acff.py``
written out, so that no change to the program moves the yardstick.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12, "tf32": 495e12,
                  "int8": 1979e12}


def padded_k(c: int) -> int:
    """K of the fuse product, 3C, padded with zero rows to a multiple of 16
    (one wgmma K step), as the bf16 kernel reads fuse_w."""
    return -(-3 * c // 16) * 16


def acff_bound(b: int, c: int, o: int, h: int, w: int
               ) -> Tuple[float, str, int, int]:
    """Least time (s) of one bf16 ACFF call on a (b, h, w, c) input with o
    outputs: the larger of its bytes over the HBM bandwidth and its
    operations over the bf16 tensor-core peak. Returns (seconds, "bytes"
    or "operations", bytes, operations).

    Bytes: one read of x and of the weights, one write of out. The
    depthwise weights and biases, fuse_b, scale and shift are fp32; fuse_w
    is bf16, K-padded. Operations: 2 * P * (27 C + 3 C O), P the output
    pixels."""
    p = b * (h - 2) * (w - 2)
    nbytes = 2 * (b * h * w * c + p * o) \
        + 4 * (27 * c + 3 * c + 3 * o) + 2 * padded_k(c) * o
    ops = 2 * p * 27 * c + 2 * p * 3 * c * o
    t_ops = ops / PEAK_OPS_PER_S["bf16"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def acff_bound_sum(b: int, blocks: Sequence[Tuple[int, int, int]]) -> float:
    """Least time (s) of the ACFF calls of one forward: ``blocks`` lists
    (c, o, input side) of each square block input."""
    return sum(acff_bound(b, c, o, s, s)[0] for c, o, s in blocks)
