from exploring_flash_attention_tpu_torch.utils.benchmark import time_cuda

__all__ = ["time_cuda"]
