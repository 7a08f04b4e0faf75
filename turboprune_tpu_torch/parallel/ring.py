"""Ring attention: sequence parallelism over the mesh's ``model`` axis (port
of ``turboprune_tpu/parallel/ring.py``).

Attention over a sequence sharded across the ranks of one model row of the
mesh (a ring), computed blockwise: each rank holds its shard of the
queries, keys and values, accumulates the online softmax (the flash
max / sum recurrence) over its own key block first, then over each other
rank's as the key/value blocks travel one hop around the ring (Ring
Attention, Liu et al. 2023). Peak memory per rank is one [S/n, S/n] score
block per head instead of [S, S].

The JAX package runs the per-device program under ``shard_map`` with
``ppermute`` hops, and XLA runs everything outside it replicated over the
``model`` axis. Here each rank runs the same program on its shard
(``_ring_attention_shard``, op for op the JAX one), with the hops as
point-to-point sends under their own autograd (``ring_shift``: the
backward is the inverse hop, as ``ppermute``'s transpose is). The
sequence is cut into shards and joined again by a conjugate pair of
autograd functions: cutting keeps the rank's slice and all-gathers the
gradients; joining all-gathers the outputs and keeps the rank's slice of
the gradient. So everything outside attention stays replicated on the
ranks of a ring, activations and gradients alike, and the parameter
gradients are averaged over the data group only (``mesh.py``).

With a model axis of one the shard program runs with no collective, which
is JAX's degradation to plain blockwise attention. No kernel is written by
hand here: the JAX package computes this with XLA einsums, no Pallas.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

_NEG_BIG = -1e30  # additive mask for padded K rows; exp(-1e30 - m) == 0


def _via_host(group) -> bool:
    """Whether the ring's tensors go through host memory: gloo's
    point-to-point calls read host pointers (it carries CUDA tensors by
    staging them itself only in its collectives)."""
    return dist.get_backend(group) == "gloo"


def _exchange(tensors: tuple, group, send_to: int, recv_from: int) -> list:
    """Send ``tensors`` to group rank ``send_to`` and receive as many of
    the same shapes and dtypes from ``recv_from``, every send and receive
    posted together, so no rank blocks on a send."""
    host = _via_host(group)
    sends = [t.detach().contiguous() for t in tensors]
    if host:
        sends = [t.cpu() for t in sends]
    recvs = [torch.empty_like(t) for t in sends]
    to, src = dist.get_global_rank(group, send_to), dist.get_global_rank(group, recv_from)
    ops = []
    for tag, (s, r) in enumerate(zip(sends, recvs)):
        ops += [dist.P2POp(dist.isend, s, to, group, tag=tag),
                dist.P2POp(dist.irecv, r, src, group, tag=tag)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)]


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order."""
    host = _via_host(group)
    src = x.detach().contiguous()
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


class _RingShift(torch.autograd.Function):
    """One hop around the ring, group rank i -> i + 1, of every tensor
    given (JAX's ``ppermute``); the backward moves the floating-point
    tensors' gradients the other way, i + 1 -> i."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        out = _exchange(tensors, group, (r + 1) % n, (r - 1) % n)
        ctx.floating = [t.is_floating_point() for t in out]
        ctx.mark_non_differentiable(*(t for t in out if not t.is_floating_point()))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        sent = tuple(g for g, f in zip(grads, ctx.floating) if f)
        back = iter(_exchange(sent, ctx.group, (r - 1) % n, (r + 1) % n))
        return (None, *(next(back) if f else None for f in ctx.floating))


def ring_shift(tensors: tuple, group) -> tuple:
    """``tensors`` one hop around ``group``'s ring, in one exchange, so
    every rank's autograd engine meets the hops in the same order."""
    return _RingShift.apply(group, *tensors)


class _SeqShard(torch.autograd.Function):
    """This rank's shard of the sequence (dim 1) of tensors replicated over
    the ring; the backward all-gathers the shards' gradients (in one
    collective), so the replicated tensors get their whole gradient on
    every rank."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        s = tensors[0].shape[1] // n
        return tuple(t.narrow(1, r * s, s).clone(memory_format=torch.contiguous_format)
                     for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        whole = _all_gather(torch.stack(grads), ctx.group, dim=2)
        return (None, *whole.unbind(0))


class _SeqGather(torch.autograd.Function):
    """The whole sequence (dim 1) from every rank's shard; the backward
    keeps this rank's shard of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        ctx.shard = x.shape[1]
        return _all_gather(x, group, dim=1)

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        return None, grad.narrow(1, r * ctx.shard, ctx.shard).contiguous()


def _ring_attention_shard(q, k, v, kv_valid, group: Optional[object] = None) -> torch.Tensor:
    """This rank's ring attention program (JAX's ``_ring_attention_shard``
    op for op). q, k, v: [batch, seq_local, heads, head_dim], this rank's
    shard; kv_valid: [seq_local] bool, False for padding rows; ``group``:
    the ring (None: a ring of one, no collective).

    The products take fp32 operands (bf16 upcast exactly), as JAX's
    ``preferred_element_type=float32`` accumulates in fp32 without
    rounding to the inputs' dtype; the online softmax's max, sum and output
    are fp32, and p is rounded to v's dtype for the p·v product."""
    n = 1 if group is None else dist.get_world_size(group)
    b, s_q, h, hd = q.shape
    qs = (q * torch.tensor(1.0 / math.sqrt(hd), dtype=q.dtype)).float()

    def accumulate(o, m, l, kv, valid):
        k, v = kv.unbind(0)
        keep = valid[None, None, None, :]
        s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
        s = torch.where(keep, s, _NEG_BIG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # Re-zero masked columns explicitly: when EVERY column so far is
        # masked, s - m_new == 0 and exp would resurrect them as weight 1.
        p = torch.exp(s - m_new[..., None]) * keep
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
        return o, m_new, l

    # Local block first, then n-1 hop-and-accumulate steps: the ring stops
    # after the LAST foreign block lands, with no dead final hop.
    o = torch.zeros((b, h, s_q, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_q), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_q), dtype=torch.float32, device=q.device)
    kv, valid = torch.stack((k, v)), kv_valid
    o, m, l = accumulate(o, m, l, kv, valid)
    for _ in range(n - 1):
        kv, valid = ring_shift((kv, valid), group)
        o, m, l = accumulate(o, m, l, kv, valid)
    out = o / torch.clamp_min(l[..., None], 1e-30)  # padded-q rows: garbage, sliced
    return out.transpose(1, 2).to(q.dtype)  # [b, s, h, hd]


def ring_attention(q, k, v, kv_valid, mesh) -> torch.Tensor:
    """Sequence-parallel self-attention over ``mesh``'s model axis.

    q/k/v: [batch, seq, heads, head_dim], the whole sequence of the
    rank's rows, the same on every rank of its ring; ``seq`` must divide
    over the ring (pad first, as ``models/vit.py`` does). kv_valid: [seq]
    bool marking real (non-padding) rows. Returns the whole sequence's
    output on every rank of the ring, and under autograd the whole
    gradients of q, k and v on every rank."""
    n = mesh.model_size
    if n == 1:
        return _ring_attention_shard(q, k, v, kv_valid)
    if q.shape[1] % n:
        raise ValueError(
            f"a sequence of {q.shape[1]} does not divide over a ring of {n}: pad it first")
    group = mesh.model_group
    q, k, v = _SeqShard.apply(group, q, k, v)
    valid = kv_valid.view(n, -1)[mesh.model_rank]
    return _SeqGather.apply(group, _ring_attention_shard(q, k, v, valid, group))
