from gamd_tpu_torch.core import space, units
from gamd_tpu_torch.core.config import (
    MDConfig,
    ModelConfig,
    SystemConfig,
    TrainConfig,
    PRESETS,
    get_preset,
    lj_model_config,
)

__all__ = [
    "space",
    "units",
    "MDConfig",
    "ModelConfig",
    "SystemConfig",
    "TrainConfig",
    "PRESETS",
    "get_preset",
    "lj_model_config",
]
