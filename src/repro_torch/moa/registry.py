"""Strategy registry, spec-string parsing, and scoped overrides.

The port of ``repro/moa/registry.py``; the spec grammar is the same::

    spec  := name [ "?" key "=" value ( "&" key "=" value )* ]

Canonical form sorts params alphabetically and omits defaults, so
``resolve(spec).spec == spec`` for canonical specs and
``resolve(s.spec) == s`` for every strategy ``s``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Type, Union

from repro_torch.moa.base import MOAStrategy

__all__ = ["register_strategy", "resolve", "available_strategies",
           "get_strategy_class", "moa_scope", "active_strategy"]

_REGISTRY: Dict[str, Type[MOAStrategy]] = {}
_PARSE_CACHE: Dict[str, MOAStrategy] = {}
_SCOPE: List[MOAStrategy] = []


def register_strategy(cls: Type[MOAStrategy]) -> Type[MOAStrategy]:
    """Class decorator: register ``cls`` under ``cls.name`` (latest wins)."""
    name = cls.name
    if not name:
        raise ValueError(f"{cls.__name__} must set a non-empty `name`")
    _REGISTRY[name] = cls
    _PARSE_CACHE.clear()
    return cls


def available_strategies() -> List[str]:
    return sorted(_REGISTRY)


def get_strategy_class(name: str) -> Type[MOAStrategy]:
    if name not in _REGISTRY:
        raise ValueError(f"unknown MOA strategy {name!r}; "
                         f"available: {available_strategies()}")
    return _REGISTRY[name]


def _coerce(cls: Type[MOAStrategy], key: str, value: str):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    if key not in fields:
        raise ValueError(
            f"strategy {cls.name!r} has no parameter {key!r}; "
            f"expected one of {sorted(fields)}")
    default = fields[key].default
    caster = type(default) if default is not dataclasses.MISSING else str
    try:
        return caster(value)
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad value {value!r} for {cls.name}.{key}") from e


def _parse(spec: str) -> MOAStrategy:
    if spec in _PARSE_CACHE:
        return _PARSE_CACHE[spec]
    name, _, query = spec.partition("?")
    cls = get_strategy_class(name.strip())
    kwargs = {}
    if query:
        for item in query.split("&"):
            key, sep, value = item.partition("=")
            if not sep:
                raise ValueError(f"malformed spec param {item!r} in {spec!r}")
            kwargs[key.strip()] = _coerce(cls, key.strip(), value.strip())
    strategy = cls(**kwargs)
    _PARSE_CACHE[spec] = strategy
    return strategy


def resolve(spec: Union[str, MOAStrategy]) -> MOAStrategy:
    """Spec string | MOAStrategy → MOAStrategy."""
    if isinstance(spec, MOAStrategy):
        return spec
    if isinstance(spec, str):
        return _parse(spec)
    raise TypeError(f"cannot resolve MOA strategy from {type(spec).__name__}")


@contextlib.contextmanager
def moa_scope(strategy: Union[str, MOAStrategy]):
    """Ambient strategy override: inside the scope every MOA-routed call
    site (``project``, the attention projections) uses ``strategy``
    regardless of its configured one. Scopes nest; the innermost wins."""
    strat = resolve(strategy)
    _SCOPE.append(strat)
    try:
        yield strat
    finally:
        _SCOPE.pop()


def active_strategy(
        default: Optional[Union[str, MOAStrategy]] = None,
) -> Optional[MOAStrategy]:
    """The ambient scoped strategy, else ``resolve(default)``, else None."""
    if _SCOPE:
        return _SCOPE[-1]
    if default is None:
        return None
    return resolve(default)
