"""Flash attention: the hand-written Hopper kernels K1 (forward), K2 (dq)
and K3 (dk, dv), their plain PyTorch versions, and the custom ops with
the autograd formula that join them.

Counterpart of ``turboprune_tpu/ops/flash.py``. Non-causal multi-head
attention with a key-validity row shared across the batch, computed
blockwise so the S x S score matrix never reaches device memory, forward
by the online-softmax recurrence and backward by recomputation from
(o, logsumexp).

- ``flash_attention`` is the public entry point, with the JAX function's
  signature and ``ValueError`` contract. It calls the custom op
  ``turboprune_tpu_torch::flash_fwd`` (K1), whose registered backward
  (the counterpart of the ``jax.custom_vjp``) calls ``::flash_bwd_dq`` (K2)
  and ``::flash_bwd_dkv`` (K3). Eager and compiled steps take this one
  route: dynamo and AOTAutograd see the ops through their fake
  implementations and call them from the graph. A CUDA tensor runs the
  kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) or raises, also
  for a ``block_k`` other than K1's 128; only a CPU tensor takes the plain
  versions.
- ``flash_attention_plain`` (K1), ``flash_bwd_dq_plain`` (K2) and
  ``flash_bwd_dkv_plain`` (K3) run the TPU kernels' recurrences over blocks
  of ``block_q``/``block_k`` in torch ops; ``flash_backward_plain`` is the
  whole backward from (o, lse). The CPU tests hold them against the Pallas
  kernels and ``chip_smoke.py`` holds the CUDA kernels against them on the
  card.
- ``flash_fwd_cuda``, ``flash_bwd_dq_cuda`` and ``flash_bwd_dkv_cuda`` are
  the kernels' wrappers; each counts its launches in ``.launches``. The
  count runs in Python, so a CUDA-graph replay of a compiled step, which
  runs no Python, does not move it: there the kernels' launches are read
  from the profiler's kernel names.
"""

from __future__ import annotations

import ctypes

import torch

NEG_BIG = -1e30
KERNEL_HEAD_DIM = 64
KERNEL_SEQ_MULTIPLE = 128
KERNEL_BLOCK_K = 128  # K1's online-softmax unit (csrc/flash_fwd.cu)
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
    marking real key rows. Returns the same shape and dtype as q.
    Differentiable in q, k and v; the mask gets no gradient."""
    _validate(q, kv_valid, block_q, block_k)
    if not (q.is_cuda or q.device.type == "cpu"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return flash_fwd(q, k, v, kv_valid, scale, block_q, block_k)[0]


# ------------------------------------------------------------- custom ops
# K1, K2 and K3 as torch.library custom ops, the counterpart of the JAX
# ``custom_vjp``: opaque to dynamo and AOTAutograd, so a compiled step
# traces through attention without a graph break and calls the kernels
# from inside its graph (and its CUDA graph). A CUDA tensor launches the
# kernel or raises; only a CPU tensor takes the plain version. Outputs are
# contiguous on both routes, as the fake implementations say.
@torch.library.custom_op("turboprune_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    scale: float,
    block_q: int,
    block_k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: (o in q's dtype, lse [bh, seq, 1] fp32)."""
    if q.is_cuda:
        check_kernel_block_k(block_k)
        return flash_fwd_cuda(q, k, v, kv_valid, scale)
    o, lse = flash_attention_plain(q, k, v, kv_valid, scale, block_q, block_k)
    return o.contiguous(), lse.contiguous()


@flash_fwd.register_fake
def _(q, k, v, kv_valid, scale, block_q, block_k):
    bh, s_len, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((bh, s_len, 1), dtype=torch.float32)


@torch.library.custom_op("turboprune_tpu_torch::flash_bwd_dq", mutates_args=())
def flash_bwd_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    drow: torch.Tensor,
    scale: float,
    block_k: int,
) -> torch.Tensor:
    """K2: dq in q's dtype."""
    if q.is_cuda:
        check_kernel_block_k(block_k)
        return flash_bwd_dq_cuda(q, k, v, kv_valid, do, lse, drow, scale)
    return flash_bwd_dq_plain(q, k, v, kv_valid, do, lse, drow, scale, block_k).contiguous()


@flash_bwd_dq.register_fake
def _(q, k, v, kv_valid, do, lse, drow, scale, block_k):
    return q.new_empty(q.shape)


@torch.library.custom_op("turboprune_tpu_torch::flash_bwd_dkv", mutates_args=())
def flash_bwd_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    drow: torch.Tensor,
    scale: float,
    block_q: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: (dk, dv) in the input dtype."""
    if q.is_cuda:
        return flash_bwd_dkv_cuda(q, k, v, kv_valid, do, lse, drow, scale)
    dk, dv = flash_bwd_dkv_plain(q, k, v, kv_valid, do, lse, drow, scale, block_q)
    return dk.contiguous(), dv.contiguous()


@flash_bwd_dkv.register_fake
def _(q, k, v, kv_valid, do, lse, drow, scale, block_q):
    return k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, kv_valid, scale, block_q, block_k = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, kv_valid, o, lse)
    ctx.scale = scale
    ctx.blocks = (block_q, block_k)
    ctx.mark_non_differentiable(lse)


def _flash_fwd_backward(ctx, do, _dlse):
    """``drow = sum_d dO*O`` by a torch reduction (an XLA reduction in
    JAX), then K2 and K3 (their plain versions on the CPU)."""
    q, k, v, kv_valid, o, lse = ctx.saved_tensors
    block_q, block_k = ctx.blocks
    drow = row_correction(o, do)
    dq = flash_bwd_dq(q, k, v, kv_valid, do, lse, drow, ctx.scale, block_k)
    dk, dv = flash_bwd_dkv(q, k, v, kv_valid, do, lse, drow, ctx.scale, block_q)
    return dq, dk, dv, None, None, None, None


flash_fwd.register_autograd(_flash_fwd_backward, setup_context=_flash_fwd_setup)


def row_correction(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``drow = sum_d dO * O`` in fp32, [bh, seq, 1]: the softmax
    derivative's per-row correction (the JAX backward's ``:230``)."""
    return (do.float() * o.float()).sum(dim=-1, keepdim=True)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    scale: float,
    block_q: int = 128,
    block_k: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU forward kernel's recurrence in torch ops: scores in fp32 from
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


def flash_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float,
    block_q: int = 128,
    block_k: int = 128,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The TPU backward in torch ops: ``drow`` as the JAX backward computes
    it, then the plain versions of K2 and K3. Returns (dq, dk, dv) in the
    input dtype."""
    _validate(q, kv_valid, block_q, block_k)
    drow = row_correction(o, do)
    dq = flash_bwd_dq_plain(q, k, v, kv_valid, do, lse, drow, scale, block_k)
    dk, dv = flash_bwd_dkv_plain(q, k, v, kv_valid, do, lse, drow, scale, block_q)
    return dq, dk, dv


def _probs_and_ds(q, k, v, do, lse, drow, valid, scale):
    """One block of the TPU backward kernels, in fp32: s = (q*scale) k^T
    with invalid keys at -1e30, p = exp(s - lse) * valid, dp = dO v^T,
    ds = p * (dp - drow) * scale."""
    s = (q * scale) @ k.transpose(1, 2)
    s = torch.where(valid, s, NEG_BIG)
    p = torch.exp(s - lse) * valid
    dp = do @ v.transpose(1, 2)
    return p, p * (dp - drow) * scale


def flash_bwd_dq_plain(q, k, v, kv_valid, do, lse, drow, scale, block_k=128):
    """``_dq_kernel``'s recurrence: walk key blocks of ``block_k``, dq +=
    ds k in fp32 (p and ds stay fp32; 16-bit operands are upcast exactly).
    Rows of dq are independent, so the walk takes all query rows at once.
    Returns dq in q's dtype."""
    valid = kv_valid.reshape(-1).to(q.device) > 0
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dq = torch.zeros_like(qf)
    for k0 in range(0, q.shape[1], block_k):
        blk = slice(k0, k0 + block_k)
        _, ds = _probs_and_ds(qf, kf[:, blk], vf[:, blk], dof, lse, drow, valid[blk], scale)
        dq = dq + ds @ kf[:, blk]
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, kv_valid, do, lse, drow, scale, block_q=128):
    """``_dkv_kernel``'s recurrence: walk query blocks of ``block_q``,
    dv += p^T dO and dk += ds^T q in fp32. Columns are independent, so the
    walk takes all keys at once. Returns (dk, dv) in the input dtype."""
    valid = kv_valid.reshape(-1).to(q.device) > 0
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, q.shape[1], block_q):
        blk = slice(q0, q0 + block_q)
        p, ds = _probs_and_ds(
            qf[:, blk], kf, vf, dof[:, blk], lse[:, blk], drow[:, blk], valid, scale
        )
        dv = dv + p.transpose(1, 2) @ dof[:, blk]
        dk = dk + ds.transpose(1, 2) @ qf[:, blk]
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels
def check_kernel_block_k(block_k: int) -> None:
    """K1 rescales its online softmax once per ``KERNEL_BLOCK_K`` keys, as
    the TPU kernel at its default block does; another ``block_k`` rounds p
    relative to other maxima, a differently rounded function, so the CUDA
    path refuses it instead of ignoring it."""
    if block_k != KERNEL_BLOCK_K:
        raise ValueError(
            f"flash_attention: the CUDA kernel rescales per {KERNEL_BLOCK_K} keys; "
            f"block_k={block_k} would compute a differently rounded function"
        )


def _kernel_operands(name: str, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """The [bh, seq, d] operands of a kernel, checked for what the kernels
    run (CUDA, one dtype of fp32/bf16/fp16, one shape, head_dim 64, seq a
    multiple of 128) and made contiguous and 16-byte aligned."""
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name}: q, k and v must be CUDA tensors")
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_CODES or any(t.dtype != dtype for t in tensors):
        raise ValueError(
            f"{name}: operands must share one of "
            f"{sorted(map(str, _DTYPE_CODES))}, got {[t.dtype for t in tensors]}"
        )
    shape = tensors[0].shape
    if len(shape) != 3 or any(t.shape != shape for t in tensors):
        raise ValueError(
            f"{name}: operands must be [bh, seq, d] of one shape, got "
            f"{[tuple(t.shape) for t in tensors]}"
        )
    if shape[2] != KERNEL_HEAD_DIM:
        raise ValueError(
            f"{name}: the kernel is built for head_dim {KERNEL_HEAD_DIM}, "
            f"got {shape[2]}"
        )
    if shape[1] % KERNEL_SEQ_MULTIPLE:
        raise ValueError(
            f"{name}: the kernel needs seq a multiple of "
            f"{KERNEL_SEQ_MULTIPLE}; seq {shape[1]} is not"
        )
    out = [t.contiguous() for t in tensors]
    if any(t.data_ptr() % 16 for t in out):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    return out


def _row_stat(name: str, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row fp32 statistic (lse, drow) as the kernels read it."""
    bh, s_len, _ = like.shape
    if t.dtype != torch.float32 or tuple(t.shape) != (bh, s_len, 1):
        raise ValueError(
            f"{name}: row statistics must be float32 [{bh}, {s_len}, 1], got "
            f"{t.dtype} {tuple(t.shape)}"
        )
    return _aligned16(t.to(like.device).contiguous())


def _valid_row(kv_valid: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return _aligned16(
        kv_valid.reshape(-1).to(device=like.device, dtype=torch.float32).contiguous()
    )


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when a view leaves it off 16 bytes: the
    16-bit backward kernels copy lse, drow and the validity row into shared
    memory 16 bytes at a time."""
    return t.clone() if t.data_ptr() % 16 else t


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def flash_fwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on the current stream. Returns (o, lse [bh, seq, 1])."""
    q, k, v = _kernel_operands("flash_fwd_cuda", q, k, v)
    bh, s_len, d = q.shape
    valid = _valid_row(kv_valid, q)
    o = torch.empty_like(q)
    lse = torch.empty((bh, s_len, 1), device=q.device, dtype=torch.float32)
    lib = _library("flash_fwd", q.device)
    err = lib.flash_fwd(
        _DTYPE_CODES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        o.data_ptr(), lse.data_ptr(),
        bh, s_len, d, float(scale), _stream(q),
    )
    _check(lib, err, "flash_fwd")
    flash_fwd_cuda.launches += 1
    return o, lse


def flash_bwd_dq_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    drow: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """Launch K2 on the current stream. ``lse`` and ``drow`` are fp32
    [bh, seq, 1]. Returns dq in q's dtype."""
    q, k, v, do = _kernel_operands("flash_bwd_dq_cuda", q, k, v, do)
    bh, s_len, d = q.shape
    lse, drow = (_row_stat("flash_bwd_dq_cuda", t, q) for t in (lse, drow))
    valid = _valid_row(kv_valid, q)
    dq = torch.empty_like(q)
    lib = _library("flash_bwd", q.device)
    err = lib.flash_bwd_dq(
        _DTYPE_CODES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        do.data_ptr(), lse.data_ptr(), drow.data_ptr(), dq.data_ptr(),
        bh, s_len, d, float(scale), _stream(q),
    )
    _check(lib, err, "flash_bwd_dq")
    flash_bwd_dq_cuda.launches += 1
    return dq


def flash_bwd_dkv_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    drow: torch.Tensor,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on the current stream. Returns (dk, dv) in the input
    dtype."""
    q, k, v, do = _kernel_operands("flash_bwd_dkv_cuda", q, k, v, do)
    bh, s_len, d = q.shape
    lse, drow = (_row_stat("flash_bwd_dkv_cuda", t, q) for t in (lse, drow))
    valid = _valid_row(kv_valid, q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _library("flash_bwd", q.device)
    err = lib.flash_bwd_dkv(
        _DTYPE_CODES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        do.data_ptr(), lse.data_ptr(), drow.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        bh, s_len, d, float(scale), _stream(q),
    )
    _check(lib, err, "flash_bwd_dkv")
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


def flash_fwd_blocks_per_sm(dtype: torch.dtype, device: torch.device) -> int:
    """Blocks of K1 for ``dtype`` that one SM of ``device`` holds at once
    (the occupancy its registers and shared memory allow)."""
    lib = _library("flash_fwd", device)
    with torch.cuda.device(device):
        n = lib.flash_fwd_blocks_per_sm(_DTYPE_CODES[dtype])
    if n < 0:
        raise RuntimeError("flash_fwd_blocks_per_sm failed")
    return n


flash_fwd_cuda.launches = 0
flash_bwd_dq_cuda.launches = 0
flash_bwd_dkv_cuda.launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
# Argument types of each library's entry points: the launches take (dtype,
# pointers..., bh, seq, d, scale, stream); flash_fwd_blocks_per_sm (dtype)
# is the kernel's occupancy on the current device. ctypes would cut an
# untyped pointer to 32 bits.
_ENTRY_POINTS = {
    "flash_fwd": {
        "flash_fwd": [_I] + [_P] * 6 + [_I, _I, _I, ctypes.c_float, _P],
        "flash_fwd_blocks_per_sm": [_I],
    },
    "flash_bwd": {
        "flash_bwd_dq": [_I] + [_P] * 8 + [_I, _I, _I, ctypes.c_float, _P],
        "flash_bwd_dkv": [_I] + [_P] * 9 + [_I, _I, _I, ctypes.c_float, _P],
    },
}
_prepared: set[tuple[str, int]] = set()


def _library(name: str, device: torch.device) -> ctypes.CDLL:
    """The kernels' library ``csrc/<name>.cu``, with its entry points typed
    and its shared-memory opt-in set once on ``device``."""
    from .build import load

    lib = load(name)
    if not hasattr(lib, "error_string"):
        for fn, argtypes in _ENTRY_POINTS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        getattr(lib, f"{name}_prepare").argtypes = []
        getattr(lib, f"{name}_prepare").restype = _I
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [_I]
        err_fn.restype = ctypes.c_char_p
        lib.error_string = err_fn
    index = device.index if device.index is not None else torch.cuda.current_device()
    if (name, index) not in _prepared:
        with torch.cuda.device(index):
            err = getattr(lib, f"{name}_prepare")()
        if err != 0:
            msg = lib.error_string(err).decode()
            raise RuntimeError(f"{name}_prepare failed: {msg} ({err})")
        _prepared.add((name, index))
    return lib
