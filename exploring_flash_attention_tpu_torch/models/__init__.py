from exploring_flash_attention_tpu_torch.models.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from exploring_flash_attention_tpu_torch.models.distill import (
    distill_draft,
    target_labeled_corpus,
)
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
from exploring_flash_attention_tpu_torch.models.seq2seq import (
    Seq2SeqConfig,
    init_seq2seq_params,
    make_seq2seq_train_step,
    seq2seq_forward,
    seq2seq_loss,
)
from exploring_flash_attention_tpu_torch.models.speculative import (
    SpeculativeEngine,
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
from exploring_flash_attention_tpu_torch.models.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from exploring_flash_attention_tpu_torch.models.weights import (
    params_from_jax,
    trainable_params_from_jax,
)

__all__ = [
    "GenerationEngine",
    "ModelConfig",
    "Seq2SeqConfig",
    "SpeculativeEngine",
    "distill_draft",
    "flagship_config",
    "forward",
    "forward_collect_kv",
    "init_params",
    "init_seq2seq_params",
    "latest_checkpoint",
    "long_context_config",
    "loss_fn",
    "make_mlm_train_step",
    "make_seq2seq_train_step",
    "make_train_step",
    "make_trainable",
    "mask_tokens",
    "mlm_loss",
    "named_param_leaves",
    "param_leaves",
    "params_from_jax",
    "restore_checkpoint",
    "rope",
    "sample",
    "save_checkpoint",
    "seq2seq_forward",
    "seq2seq_loss",
    "target_labeled_corpus",
    "trainable_params_from_jax",
    "tree_leaves",
    "tree_map",
    "tree_unflatten",
]
