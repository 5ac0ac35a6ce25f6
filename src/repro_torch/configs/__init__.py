from repro_torch.configs.base import (  # noqa: F401
    get_config, list_archs, MambaConfig, MLAConfig, ModelConfig, MoEConfig,
    register, SHAPES, ShapeSpec, smoke_config)

# detcheck tier manifest (docs/ANALYSIS.md):
# static model shapes; registration side effects only
DETCHECK_TIER = "environment"
