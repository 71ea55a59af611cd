"""FPGA ALM model (paper Figs. 4 and 5) and the LOA op count — the port's
copy of the pure-Python parts of ``repro/core/cost_model.py`` that the
paper path and ``LOAStrategy.cost`` read.

Calibrated to an Intel Stratix V 5SGXEA7 (the paper's device, 8-bit
operands):

* one ALM implements two bits of a binary adder, so a ``w``-bit adder is
  ``ceil(w/2)`` ALMs;
* an adder tree over ``n`` operands has ``ceil(log2 n)`` levels whose adders
  grow one bit per level;
* the §3.1 serializer is a parallel-load shift register, one ALM per bit:
  linear in the cluster size ``n_c`` (the Fig. 4 overhead);
* the accumulator is one adder of width ``b + ceil(log2 n_c)``;
* the §3.2 LOA occupies the same ALMs whatever ``l`` (Fig. 5, bottom).

The op counts ``vpu_ops_exact_add`` / ``vpu_ops_loa_add`` are the
reference's count of vector ops per element-wise add (1 hard add against ~6
ops for the LOA gates); they price the LOA strategy and are a count, not a
time. The reference's TPU roofline constants are not copied: no number of
the port is priced against a TPU.
"""

from __future__ import annotations

import math

__all__ = ["alm_binary_adder", "alm_adder_tree", "alm_serializer",
           "alm_accumulator", "alm_serial_moa", "alm_loa_adder",
           "alm_scm_multiplier", "vpu_ops_exact_add", "vpu_ops_loa_add"]

ALM_BITS_PER_ADDER = 2  # hard carry chain: 2 full-adder bits per ALM

# one full ALM per serializer bit (load/shift mux + FF + clock crossing);
# calibrated so the serialized MOA loses to the tree at every n_c (Fig. 4)
ALM_PER_SERIALIZER_BIT = 1.0

# Voronenko–Püschel MCM sharing: mean adders per generic constant after
# sharing, calibrated to the paper's "69 % of conv1 logic is MOA"
MCM_SHARING = 0.43


def alm_binary_adder(width: int) -> int:
    """ALMs for one two-operand ripple adder of ``width`` bits."""
    return math.ceil(width / ALM_BITS_PER_ADDER)


def alm_adder_tree(n_operands: int, width: int) -> int:
    """ALMs for the synthesis-default binary adder tree (Fig. 1)."""
    if n_operands <= 1:
        return 0
    total = 0
    remaining = n_operands
    level_width = width
    while remaining > 1:
        pairs = remaining // 2
        total += pairs * alm_binary_adder(level_width + 1)
        remaining = pairs + (remaining % 2)
        level_width += 1
    return total


def alm_serializer(n_inputs: int, width: int) -> int:
    """ALMs for the parallel-to-serial register feeding the accumulator."""
    return math.ceil(n_inputs * width * ALM_PER_SERIALIZER_BIT)


def alm_accumulator(n_inputs: int, width: int) -> int:
    """ALMs for the serial accumulator (adder sized for n_inputs sums)."""
    acc_width = width + max(1, math.ceil(math.log2(max(n_inputs, 2))))
    return alm_binary_adder(acc_width)


def alm_serial_moa(n_inputs: int, width: int) -> int:
    """Total §3.1 serialized MOA: serializer + accumulator (Fig. 2)."""
    return alm_serializer(n_inputs, width) + alm_accumulator(n_inputs, width)


def alm_loa_adder(width: int, approx_bits: int) -> int:
    """ALMs for one LOA — flat in ``approx_bits`` (Fig. 5's negative
    result: each ALM's hard full adder computes an exact or an OR bit
    pair in the same cell)."""
    del approx_bits
    return alm_binary_adder(width)


def alm_scm_multiplier(bits: int) -> float:
    """Mean ALMs for a generic (non-zero, non-power-of-two) SCM multiplier:
    ~bits/3 − 1 CSD adders of width ``bits``, shared by ``MCM_SHARING``."""
    adders = max(bits / 3.0 - 1.0, 0.5) * MCM_SHARING
    return adders * alm_binary_adder(bits)


def vpu_ops_exact_add() -> int:
    """Vector ops per element-wise exact add: one hard add."""
    return 1


def vpu_ops_loa_add() -> int:
    """Vector ops per element-wise LOA add: the mask / OR / AND-carry /
    shift gates around the exact high add, ~6 fused integer ops."""
    return 6
