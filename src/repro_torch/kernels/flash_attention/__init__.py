from repro_torch.kernels.flash_attention.ops import MAX_HEAD_DIM, flash_attention, route
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["MAX_HEAD_DIM", "attention_ref", "flash_attention", "route"]
