"""PyTorch + CUDA port of exploring_flash_attention_tpu for NVIDIA Hopper.

The JAX package beside it is the reference.  This package imports torch
and NumPy, never JAX.  Kernels written by hand for sm_90a live in
``csrc/`` and are built at first use on a CUDA tensor (``kernels.py``); on
CPU tensors every kernel wrapper runs its plain PyTorch version.
"""

from exploring_flash_attention_tpu_torch.configs import (
    MeshConfig,
    Precision,
    SplitKVConfig,
    TileConfig,
    cdiv,
)
from exploring_flash_attention_tpu_torch.models import (
    GenerationEngine,
    ModelConfig,
    forward,
    init_params,
    loss_fn,
    make_train_step,
)
from exploring_flash_attention_tpu_torch.ops import (
    QuantizedTensor,
    attention_bwd_plain,
    attention_partial_local,
    flash_attention,
    flash_attention_bwd,
    flash_attention_int8,
    flash_attention_kvquant,
    flash_attention_splitkv_partial,
    flash_attention_v1,
    flash_attention_v1_causal_partial,
    flash_attention_v1_dtiled,
    flash_attention_v1_window_partial,
    flash_attention_v2,
    merge_partials,
    quantize_fp8,
    quantize_int8,
    splitkv_combine,
)
from exploring_flash_attention_tpu_torch.oracle import (
    check_accuracy,
    naive_attention,
    print_comparison,
)

__all__ = [
    "GenerationEngine",
    "MeshConfig",
    "Precision",
    "QuantizedTensor",
    "ModelConfig",
    "SplitKVConfig",
    "TileConfig",
    "attention_bwd_plain",
    "attention_partial_local",
    "cdiv",
    "check_accuracy",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_int8",
    "flash_attention_kvquant",
    "flash_attention_splitkv_partial",
    "flash_attention_v1",
    "flash_attention_v1_causal_partial",
    "flash_attention_v1_dtiled",
    "flash_attention_v1_window_partial",
    "flash_attention_v2",
    "forward",
    "init_params",
    "loss_fn",
    "make_train_step",
    "merge_partials",
    "naive_attention",
    "print_comparison",
    "quantize_fp8",
    "quantize_int8",
    "splitkv_combine",
]
