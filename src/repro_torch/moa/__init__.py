"""Pluggable Multi-Operand-Adder engine — the port of :mod:`repro.moa`.

Public surface::

    from repro_torch.moa import (MOAStrategy, TreeStrategy, SerialStrategy,
                                 LOAStrategy, register_strategy, resolve,
                                 moa_scope, active_strategy)
"""

from repro_torch.moa.base import BACKENDS, MOAStrategy, resolved_backend
from repro_torch.moa.backends import chunked_matmul
from repro_torch.moa.registry import (active_strategy, available_strategies,
                                      get_strategy_class, moa_scope,
                                      register_strategy, resolve)
from repro_torch.moa.strategies import (LOAStrategy, SerialStrategy,
                                        TreeStrategy)

__all__ = [
    "MOAStrategy", "TreeStrategy", "SerialStrategy", "LOAStrategy",
    "BACKENDS", "resolved_backend", "chunked_matmul",
    "register_strategy", "resolve", "available_strategies",
    "get_strategy_class", "moa_scope", "active_strategy",
]
