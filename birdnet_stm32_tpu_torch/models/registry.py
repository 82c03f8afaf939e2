"""Frontend registry: named frontend metadata (port of models/registry.py).

Frozen records, duplicate names rejected, five built-ins. `n6_compatible`
flags what the STM32N6 deployment target accepts.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FrontendInfo:
    """Metadata for a registered audio frontend.

    Attributes:
        name: Canonical frontend name.
        mode: In-graph mode ('precomputed' | 'hybrid' | 'raw').
        precomputed: True when features are computed outside the model graph.
        n6_compatible: Whether the reference deployment target supports it.
    """

    name: str
    mode: str
    precomputed: bool
    n6_compatible: bool


_REGISTRY: dict[str, FrontendInfo] = {}


def register_frontend(info: FrontendInfo) -> None:
    """Register a frontend; duplicate names are rejected."""
    if info.name in _REGISTRY:
        raise ValueError(f"Frontend {info.name!r} is already registered")
    if info.mode not in ("precomputed", "hybrid", "raw"):
        raise ValueError(f"Invalid frontend mode: {info.mode!r}")
    _REGISTRY[info.name] = info


def get_frontend_info(name: str) -> FrontendInfo:
    if name not in _REGISTRY:
        raise KeyError(f"Unknown frontend {name!r}. Registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def is_precomputed(name: str) -> bool:
    return get_frontend_info(name).precomputed


def is_n6_compatible(name: str) -> bool:
    return get_frontend_info(name).n6_compatible


def registered_frontends() -> list[str]:
    return sorted(_REGISTRY)


# The other spelling.
list_frontends = registered_frontends


# Built-ins.
for _info in (
    FrontendInfo("librosa", "precomputed", True, True),
    FrontendInfo("hybrid", "hybrid", False, True),
    FrontendInfo("raw", "raw", False, True),
    FrontendInfo("mfcc", "precomputed", True, True),
    FrontendInfo("log_mel", "precomputed", True, True),
):
    register_frontend(_info)
