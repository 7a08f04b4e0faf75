from . import masking
from .flash import (
    flash_attention,
    flash_attention_plain,
    flash_backward_plain,
    flash_bwd_dkv,
    flash_bwd_dkv_cuda,
    flash_bwd_dq,
    flash_bwd_dq_cuda,
    flash_fwd,
    flash_fwd_cuda,
)

__all__ = [
    "masking",
    "flash_attention",
    "flash_attention_plain",
    "flash_backward_plain",
    "flash_bwd_dkv",
    "flash_bwd_dkv_cuda",
    "flash_bwd_dq",
    "flash_bwd_dq_cuda",
    "flash_fwd",
    "flash_fwd_cuda",
]
