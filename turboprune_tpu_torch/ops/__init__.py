from . import masking
from .flash import flash_attention, flash_attention_plain, flash_fwd_cuda

__all__ = [
    "masking",
    "flash_attention",
    "flash_attention_plain",
    "flash_fwd_cuda",
]
