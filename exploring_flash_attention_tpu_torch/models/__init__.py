from exploring_flash_attention_tpu_torch.models.generate import (
    GenerationEngine,
    forward_collect_kv,
    sample,
)
from exploring_flash_attention_tpu_torch.models.transformer import (
    ModelConfig,
    flagship_config,
    forward,
    init_params,
    rope,
)
from exploring_flash_attention_tpu_torch.models.weights import params_from_jax

__all__ = [
    "GenerationEngine",
    "ModelConfig",
    "flagship_config",
    "forward",
    "forward_collect_kv",
    "init_params",
    "params_from_jax",
    "rope",
    "sample",
]
