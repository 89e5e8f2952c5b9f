"""Architecture configs: one module per assigned arch + the paper's own
Sinkhorn-WMD workload. See `repro_torch.configs.registry` for --arch
dispatch. Plain data (stdlib only), copies of `repro.configs`."""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      EncoderConfig, SHAPES, ShapeConfig)
from repro_torch.configs.registry import (arch_ids, cell_supported, cells,
                                          get_config, get_shape,
                                          get_smoke_config)

__all__ = [
    "MLAConfig", "ModelConfig", "MoEConfig", "EncoderConfig", "SHAPES",
    "ShapeConfig", "arch_ids", "cell_supported", "cells", "get_config",
    "get_shape", "get_smoke_config",
]
