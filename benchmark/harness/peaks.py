"""The yardstick's peaks and the suppression kernel's bound.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the 700 W limit): 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside
the tensor cores, 3.35 TB/s of HBM. The bound of greedy suppression is a
frozen copy of chip_smoke.py's `suppress_bound` rule.
"""

from __future__ import annotations

BF16_FLOPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def suppress_bound_s(b: int, k: int, tail: int) -> float:
    """Least seconds of one launch of greedy suppression over a (b, k)
    candidate batch whose kept candidates' row tails M[i, i+1:] hold `tail`
    f32 entries in all: each of those read and compared once, keep0 read
    and keep written once (one byte each)."""
    nbytes = 4 * tail + 2 * b * k
    return max(nbytes / HBM_BYTES_PER_S, tail / F32_OPS_PER_S)
