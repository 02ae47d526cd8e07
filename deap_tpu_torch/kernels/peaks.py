"""The H100's data-sheet peaks and the least time of a kernel's work at
them: the yardstick of every kernel bound that ``chip_smoke.py`` and the
probe tools report.  Plain Python, no PyTorch."""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "FP32_INSTR_PER_S", "INT32_INSTR_PER_S",
           "FP64_INSTR_PER_S", "ISSUE_PER_S", "bound_ms"]

# The H100 SXM's data sheet, at its full 700 W power limit: 3.35 TB/s of
# HBM3; 132 SMs at the 1.98 GHz that the 67 TFLOP/s float32 peak implies
# (132 x 128 lanes x 2 x 1.98e9).  Per SM and clock: 128 float32
# add/multiply/FMA (an FMA is one instruction, hence half the FLOP rate);
# 64 of 32-bit integer add, shift and logic, and 64 compares (float32
# compares included: "compare, minimum, maximum", CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0); 64
# float64 lanes; 128 instructions issued in all.
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
INT32_INSTR_PER_S = 67e12 / 4      # integer and compare instructions
FP64_INSTR_PER_S = 67e12 / 4
ISSUE_PER_S = 67e12 / 2


def bound_ms(n_bytes: float, ints: float = 0, flts: float = 0,
             dbls: float = 0):
    """``(ms, "bytes" | "operations")``: the least time for moving
    ``n_bytes`` once and issuing the integer, float32 and float64
    instructions, at the data-sheet rates above."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ints / INT32_INSTR_PER_S, flts / FP32_INSTR_PER_S,
                dbls / FP64_INSTR_PER_S,
                (ints + flts + dbls) / ISSUE_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
