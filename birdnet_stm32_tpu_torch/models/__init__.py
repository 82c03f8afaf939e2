"""Model family (port of birdnet_stm32_tpu/models/): the DS-CNN backbone,
EfficientNet-B1 (the port's own, models/efficientnet.py), in-graph audio
frontends, blocks, and the registry of model builders, keyed by the name a
configuration's `architecture` gives ("dscnn", "efficientnet_b1")::

    from birdnet_stm32_tpu_torch.models import build_model
    model = build_model(cfg.architecture, cfg, class_activation="none", device="cpu")
"""

from __future__ import annotations

from typing import Any, Callable

from birdnet_stm32_tpu_torch.models.blocks import make_divisible
from birdnet_stm32_tpu_torch.models.dscnn import DSCNN, build_dscnn
from birdnet_stm32_tpu_torch.models.efficientnet import EfficientNet, build_efficientnet

# Model registry: name -> builder (cfg: ModelConfig, **kwargs) -> nn.Module.
_MODEL_REGISTRY: dict[str, Callable[..., Any]] = {}


def register_model(name: str):
    """Decorator registering a model builder under a name. The builder takes
    (cfg: ModelConfig, **kwargs) and returns a module; a name registered
    already raises ValueError."""

    def decorator(fn: Callable[..., Any]) -> Callable[..., Any]:
        if name in _MODEL_REGISTRY:
            raise ValueError(
                f"a model builder named {name!r} exists; pick another name "
                "or remove the old registration first")
        _MODEL_REGISTRY[name] = fn
        return fn

    return decorator


def build_model(name: str, cfg, **kwargs: Any):
    """Build a model by registered name; KeyError for an unknown name."""
    if name not in _MODEL_REGISTRY:
        raise KeyError(
            f"no model builder registered under {name!r} "
            f"(registered: {list_models()})")
    return _MODEL_REGISTRY[name](cfg, **kwargs)


def list_models() -> list[str]:
    """All registered model names, sorted."""
    return sorted(_MODEL_REGISTRY)


_MODEL_REGISTRY["dscnn"] = build_dscnn
register_model("efficientnet_b1")(build_efficientnet)

__all__ = ["DSCNN", "build_dscnn", "EfficientNet", "build_efficientnet", "make_divisible",
           "register_model", "build_model", "list_models"]
