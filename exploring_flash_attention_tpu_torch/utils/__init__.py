from exploring_flash_attention_tpu_torch.utils.autotune import (
    autotune_dtiled,
    autotune_splitkv,
    autotune_v1,
    autotune_window,
)
from exploring_flash_attention_tpu_torch.utils.benchmark import (
    attention_flops,
    roofline_attention_tflops,
    time_cuda,
    time_fn_chained,
    time_fn_chained_windows,
)
from exploring_flash_attention_tpu_torch.utils.profiling import (
    kernel_report,
    roofline_tflops,
    trace,
)

__all__ = [
    "autotune_dtiled",
    "autotune_splitkv",
    "autotune_v1",
    "autotune_window",
    "time_cuda",
    "time_fn_chained",
    "time_fn_chained_windows",
    "attention_flops",
    "roofline_attention_tflops",
    "kernel_report",
    "roofline_tflops",
    "trace",
]
