"""Flash-attention forward: the hand-written Hopper kernel K1 and its plain
PyTorch version.

Counterpart of ``turboprune_tpu/ops/flash.py`` (forward only). Non-causal
multi-head attention with a key-validity row shared across the batch,
computed blockwise by the online-softmax recurrence so the S x S score
matrix never reaches device memory.

- ``flash_attention`` is the public entry point, with the JAX function's
  signature and ``ValueError`` contract. A CUDA tensor goes to the CUDA
  kernel (``csrc/flash_fwd.cu``) or raises; only a CPU tensor takes the
  plain version.
- ``flash_attention_plain`` runs the same recurrence over key blocks of
  ``block_k`` in torch ops. The CPU tests hold it against the Pallas kernel
  and ``chip_smoke.py`` holds the CUDA kernel against it on the card.
- ``flash_fwd_cuda`` is the kernel's wrapper. ``flash_fwd_cuda.launches``
  counts its launches.

The backward kernels (K2/K3 in ROADMAP.md) are a later slice: on CUDA a
input that requires grad raises rather than letting autograd differentiate
a path the kernel never ran.
"""

from __future__ import annotations

import ctypes

import torch

NEG_BIG = -1e30
KERNEL_HEAD_DIM = 64
KERNEL_BLOCK_K = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _validate(q, kv_valid, block_q: int, block_k: int) -> None:
    s_len = q.shape[1]
    if s_len % block_q or s_len % block_k:
        raise ValueError(
            f"flash_attention: seq {s_len} must be a multiple of "
            f"block_q={block_q} and block_k={block_k} — pad the sequence "
            "(the grid floor-divides and would silently drop the tail)"
        )
    if tuple(kv_valid.shape) != (1, s_len):
        raise ValueError(
            f"flash_attention: kv_valid must have shape (1, {s_len}), got "
            f"{tuple(kv_valid.shape)} — the mask is shared across the batch "
            "(a per-example mask would be silently ignored)"
        )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    scale: float,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Blockwise (flash) attention. q/k/v: [batch*heads, seq, head_dim];
    ``block_q``/``block_k`` must divide ``seq``. kv_valid: [1, seq] (0/1)
    marking real key rows. Returns the same shape and dtype as q."""
    _validate(q, kv_valid, block_q, block_k)
    if q.is_cuda:
        o, _ = flash_fwd_cuda(q, k, v, kv_valid, scale)
        return o
    if q.device.type == "cpu":
        o, _ = flash_attention_plain(q, k, v, kv_valid, scale, block_q, block_k)
        return o
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    scale: float,
    block_q: int = 128,
    block_k: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's recurrence in torch ops: scores in fp32 from
    upcast q (times scale) and k, invalid keys at -1e30, running max and
    sum in fp32, p rounded to v's dtype before an fp32-accumulated PV.
    Query rows are independent, so ``block_q`` only has to divide seq.
    Returns (o [bh, seq, d] in q's dtype, lse [bh, seq, 1] fp32)."""
    _validate(q, kv_valid, block_q, block_k)
    bh, s_len, d = q.shape
    valid = kv_valid.reshape(-1).to(q.device) > 0
    qf = q.float() * scale
    kf = k.float()
    m = torch.full((bh, s_len, 1), float("-inf"), device=q.device)
    l = torch.zeros((bh, s_len, 1), device=q.device)
    acc = torch.zeros((bh, s_len, d), device=q.device)
    for k0 in range(0, s_len, block_k):
        vb = valid[k0 : k0 + block_k]
        s = qf @ kf[:, k0 : k0 + block_k].transpose(1, 2)
        s = torch.where(vb, s, NEG_BIG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new) * vb
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        # p in v's dtype times v, accumulated in fp32: products of two
        # 16-bit values are exact in fp32, so the fp32 matmul of the upcast
        # operands is the fp32-accumulated product the kernels compute.
        pv = p.to(v.dtype).float() @ v[:, k0 : k0 + block_k].float()
        acc = acc * corr + pv
        m = m_new
    lsafe = torch.clamp_min(l, 1e-30)
    return (acc / lsafe).to(q.dtype), m + torch.log(lsafe)


def flash_fwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on the current stream. The kernel walks key tiles of
    ``KERNEL_BLOCK_K``, so seq must be a multiple of it. Returns
    (o, lse [bh, seq, 1])."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_fwd_cuda: q, k and v must be CUDA tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash backward kernels (K2/K3) are a later slice"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_fwd_cuda: q/k/v must share one of "
            f"{sorted(map(str, _DTYPE_CODES))}, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_fwd_cuda: q/k/v must be [bh, seq, d] of one shape, got "
            f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}"
        )
    bh, s_len, d = q.shape
    if d != KERNEL_HEAD_DIM:
        raise ValueError(
            f"flash_fwd_cuda: the kernel is built for head_dim "
            f"{KERNEL_HEAD_DIM}, got {d}"
        )
    if s_len % KERNEL_BLOCK_K:
        raise ValueError(
            f"flash_fwd_cuda: the kernel runs key tiles of {KERNEL_BLOCK_K}; "
            f"seq {s_len} is not a multiple"
        )
    q, k, v = (t.contiguous() for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_fwd_cuda: q/k/v must be 16-byte aligned")
    valid = kv_valid.reshape(-1).to(device=q.device, dtype=torch.float32)
    valid = valid.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((bh, s_len, 1), device=q.device, dtype=torch.float32)
    lib = _library(q.device)
    err = lib.flash_fwd(
        _DTYPE_CODES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        o.data_ptr(), lse.data_ptr(),
        bh, s_len, d, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        msg = lib.flash_fwd_error_string(err).decode()
        raise RuntimeError(f"flash_fwd kernel launch failed: {msg} ({err})")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0

_prepared_devices: set[int] = set()


def _library(device: torch.device) -> ctypes.CDLL:
    """The kernel's library, with its shared-memory opt-in set once on
    ``device``."""
    from .build import load

    lib = load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        lib.flash_fwd_prepare.argtypes = []
        lib.flash_fwd_prepare.restype = ctypes.c_int
        lib.flash_fwd.argtypes = [
            ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _prepared_devices:
        with torch.cuda.device(index):
            err = lib.flash_fwd_prepare()
        if err != 0:
            msg = lib.flash_fwd_error_string(err).decode()
            raise RuntimeError(f"flash_fwd_prepare failed: {msg} ({err})")
        _prepared_devices.add(index)
    return lib
