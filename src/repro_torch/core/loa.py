"""Lower-part-OR approximate adder (LOA), bitwise — the port of
``repro/core/loa.py``.

Mahdiani et al., TCAS-I 2010; the adder of the paper's §3.2, Fig. 3 and
Fig. 5. For a ``b``-bit adder with ``l`` approximated low bits
(0 <= l <= b), operands read as unsigned ``b``-bit integers::

    low  = (x & mask_l) | (y & mask_l)                 # bit-wise OR "sum"
    cin  = (x >> (l-1)) & (y >> (l-1)) & 1  if l > 0   # AND of lower MSBs
    high = (x >> l) + (y >> l) + cin                    # exact sub-adder
    s̃   = (high << l) | low

``l == 0`` is the exact adder; the exact sub-adder keeps its carry-out, so
a result may take ``b+1`` bits. Tensors are int32 containers (``>>`` is
arithmetic, sums wrap modulo 2**32, as the reference's jnp int32).
"""

from __future__ import annotations

import math

import torch

__all__ = ["loa_add", "loa_sum", "loa_error_bound", "exact_bits_required",
           "loa_add_reference_python"]


def _as_int32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def loa_add(x, y, *, approx_bits: int, width: int = 8) -> torch.Tensor:
    """Approximate LOA addition of unsigned ``width``-bit operands; int32
    result (possibly ``width + 1`` bits)."""
    if not 0 <= approx_bits <= width:
        raise ValueError(
            f"approx_bits={approx_bits} outside [0, width={width}]")
    x, y = _as_int32(x), _as_int32(y)
    if approx_bits == 0:
        return x + y
    l = approx_bits
    mask = (1 << l) - 1
    low = (x & mask) | (y & mask)
    cin = ((x >> (l - 1)) & (y >> (l - 1))) & 1
    high = (x >> l) + (y >> l) + cin
    return (high << l) | low


def loa_sum(operands, *, approx_bits: int, width: int = 8,
            axis: int = -1) -> torch.Tensor:
    """Multi-operand reduction through a balanced binary tree of LOAs
    (every adder of Fig. 1's tree is an LOA; odd leftovers pass through).
    The level width grows one bit per level; ``approx_bits`` stays fixed."""
    x = torch.movedim(_as_int32(operands), axis, 0)
    if x.shape[0] == 0:
        raise ValueError("loa_sum needs at least one operand")
    level_width = width
    while x.shape[0] > 1:
        m = x.shape[0]
        half = m // 2
        paired = loa_add(x[: 2 * half: 2], x[1: 2 * half: 2],
                         approx_bits=approx_bits, width=level_width)
        if m % 2:
            paired = torch.cat([paired, x[2 * half:]], dim=0)
        x = paired
        level_width += 1
    return x[0]


def loa_error_bound(approx_bits: int) -> int:
    """Worst-case absolute error of one LOA addition (``< 2**l``)."""
    if approx_bits == 0:
        return 0
    return (1 << approx_bits) - 1


def exact_bits_required(n_operands: int, width: int) -> int:
    """Bit-width of the exact sum of ``n`` unsigned ``width``-bit operands."""
    return width + max(0, math.ceil(math.log2(max(n_operands, 1))))


def loa_add_reference_python(x: int, y: int, approx_bits: int) -> int:
    """Scalar pure-Python model (a third oracle for the tests)."""
    l = approx_bits
    if l == 0:
        return x + y
    mask = (1 << l) - 1
    low = (x & mask) | (y & mask)
    cin = (x >> (l - 1)) & (y >> (l - 1)) & 1
    high = (x >> l) + (y >> l) + cin
    return (high << l) | low
