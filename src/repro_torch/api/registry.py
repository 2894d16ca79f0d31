"""String-keyed backend registry for ``NeighborIndex`` implementations.

New engines (IVF-style coarse quantizers, multi-device grids, ...) register
with ``@register_backend("name")`` and immediately become reachable through
``build_index(points, backend="name")`` — no call-site changes anywhere.
"""

from __future__ import annotations

from typing import Callable, Dict, Type

__all__ = ["register_backend", "get_backend", "available_backends"]

_BACKENDS: Dict[str, type] = {}


def register_backend(name: str) -> Callable[[type], type]:
    """Class decorator: register ``cls`` under ``name``.

    Re-registering a name overwrites (lets tests/plugins swap engines), but
    the class must implement the ``NeighborIndex`` protocol — enforced at
    build time, not here, so the registry stays import-light.
    """

    def deco(cls: type) -> type:
        cls.backend_name = name
        _BACKENDS[name] = cls
        return cls

    return deco


def get_backend(name: str) -> Type:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown neighbor-search backend {name!r}; "
            f"registered: {available_backends()}"
        ) from None


def available_backends() -> list:
    return sorted(_BACKENDS)
