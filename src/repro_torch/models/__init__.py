"""Model layer: composable decoder stack + per-arch configuration."""
from .config import SHAPES, InputShape, ModelConfig, cell_supported, input_specs
from .transformer import (
    Transformer,
    active_param_count,
    decode_step,
    forward_train,
    init_cache,
    init_params,
    param_count,
    params_from_reference,
    prefill,
)
