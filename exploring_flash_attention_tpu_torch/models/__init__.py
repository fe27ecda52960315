from exploring_flash_attention_tpu_torch.models.encoder import (
    make_mlm_train_step,
    mask_tokens,
    mlm_loss,
)
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
    long_context_config,
    loss_fn,
    make_train_step,
    make_trainable,
    named_param_leaves,
    param_leaves,
    rope,
)
from exploring_flash_attention_tpu_torch.models.weights import (
    params_from_jax,
    trainable_params_from_jax,
)

__all__ = [
    "GenerationEngine",
    "ModelConfig",
    "flagship_config",
    "forward",
    "forward_collect_kv",
    "init_params",
    "long_context_config",
    "loss_fn",
    "make_mlm_train_step",
    "make_train_step",
    "make_trainable",
    "mask_tokens",
    "mlm_loss",
    "named_param_leaves",
    "param_leaves",
    "params_from_jax",
    "rope",
    "sample",
    "trainable_params_from_jax",
]
