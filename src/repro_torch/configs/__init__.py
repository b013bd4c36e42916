"""Config registry: ``get_config(name)``.  Only the paper's model family
(``dsv2-lite``) is ported so far; other names raise ``NotImplementedError``."""

from repro_torch.configs.base import ModelConfig, cache_specs, check_supported
from repro_torch.configs.dsv2_lite import CONFIG as DSV2_LITE

REGISTRY = {DSV2_LITE.name: DSV2_LITE}


def get_config(name: str) -> ModelConfig:
    base = name[: -len("-reduced")] if name.endswith("-reduced") else name
    if base not in REGISTRY:
        raise NotImplementedError(
            f"config {name!r} is not ported yet (ported: {sorted(REGISTRY)})"
        )
    cfg = REGISTRY[base]
    return cfg.reduced() if name.endswith("-reduced") else cfg


__all__ = ["REGISTRY", "ModelConfig", "cache_specs", "check_supported", "get_config"]
