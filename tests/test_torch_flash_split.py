"""The 16-bit flash backward kernels' arithmetic (csrc/flash_bwd.cu), emulated
in torch on the CPU.

The kernels keep p and ds in fp32, as the TPU kernels do, and run the three
products with an fp32 operand (ds k in K2; p^T dO and ds^T q in K3) on the
tensor cores by splitting that operand into 16-bit hi = rn(x) and
lo = rn(x - hi) terms: each product is hi B + lo B over 16-bit values, whose
products are exact in fp32, summed in fp32. The emulation below forms the
gradients that way, tile by tile (64 keys for K2, 64 queries for K3), at
ragged shapes, and holds them

- against ``jax.grad`` of the JAX package's ``flash_attention`` (its backward
  is the Pallas kernels K2/K3, in interpret mode on the CPU, as
  tests/test_flash.py runs them), rounded to the input dtype, within
  tests/test_flash.py's 16-bit tolerance (atol 3e-2);
- against the fp32 recurrence of ``flash_bwd_dq_plain`` /
  ``flash_bwd_dkv_plain``, both in fp32 before any rounding to the input
  dtype: within 2^-15 of each gradient's norm with two terms (the split
  keeps the operand to 2^-16 of its value in bf16), while one term, p and
  ds rounded to the input dtype, lands farther than that.

Inputs are made with numpy from a seed and handed to both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from turboprune_tpu.ops.flash import flash_attention as jax_flash
from turboprune_tpu_torch.ops import flash as torch_flash

SCALE = 0.125  # 1 / sqrt(64)
TILE = 64  # rows of the kernels' tiles
SPLIT_REL = 2.0**-15
JAX_ATOL = 3e-2  # tests/test_flash.py's bf16 tolerance
SHAPES = [(4, 256, 197), (2, 384, 301)]  # (b*h, seq, valid keys)
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp16": (torch.float16, jnp.float16)}


def split(x: torch.Tensor, dtype: torch.dtype, terms: int) -> list[torch.Tensor]:
    """fp32 ``x`` as ``terms`` values of ``dtype``, each the rounding of
    what the ones before it leave."""
    parts = []
    for _ in range(terms):
        parts.append(x.to(dtype))
        x = x - parts[-1].float()
    return parts


def split_matmul(x: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """x @ b on the tensor cores' terms: fp32 ``x`` split into terms of
    ``b``'s 16-bit dtype, each product of upcast 16-bit values summed in
    fp32."""
    out = torch.zeros(x.shape[0], x.shape[1], b.shape[2])
    for part in split(x, b.dtype, terms):
        out = out + part.float() @ b.float()
    return out


def probs_and_ds(q, k, v, do, lse, drow, ok):
    """s = (q k^T) scale from 16-bit operands, p = exp(s - lse) with invalid
    keys at 0, dp = dO v^T, ds = p (dp - drow) scale, all fp32."""
    s = (q.float() @ k.float().transpose(1, 2)) * SCALE
    p = torch.where(ok, torch.exp(s - lse), 0.0)
    dp = do.float() @ v.float().transpose(1, 2)
    return p, p * (dp - drow) * SCALE


def emulate(q, k, v, valid, do, lse, drow, terms):
    """(dq, dk, dv) in fp32 as the 16-bit kernels form them: K2 walks key
    tiles, K3 query tiles; rows of each output are independent."""
    ok = valid.reshape(-1) > 0
    seq = q.shape[1]
    dq = torch.zeros(q.shape)
    dk = torch.zeros(q.shape)
    dv = torch.zeros(q.shape)
    for k0 in range(0, seq, TILE):
        blk = slice(k0, k0 + TILE)
        _, ds = probs_and_ds(q, k[:, blk], v[:, blk], do, lse, drow, ok[blk])
        dq = dq + split_matmul(ds, k[:, blk], terms)
    for q0 in range(0, seq, TILE):
        blk = slice(q0, q0 + TILE)
        p, ds = probs_and_ds(q[:, blk], k, v, do[:, blk], lse[:, blk], drow[:, blk], ok)
        dv = dv + split_matmul(p.transpose(1, 2), do[:, blk], terms)
        dk = dk + split_matmul(ds.transpose(1, 2), q[:, blk], terms)
    return dq, dk, dv


def inputs(bh, seq, n_valid, seed):
    """q, k, v and the upstream cotangent (numpy fp32), and the validity row."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(bh, seq, 64)).astype(np.float32) for _ in range(4)]
    valid = (np.arange(seq) < n_valid).astype(np.float32)[None]
    return arrays, valid


def torch_operands(arrays, valid, dtype):
    """The kernels' operands from the port's plain forward: q, k, v, dO in
    ``dtype``, the validity row, lse and drow (fp32)."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrays)
    mask = torch.from_numpy(valid)
    o, lse = torch_flash.flash_attention_plain(q, k, v, mask, SCALE)
    return q, k, v, mask, do, lse, torch_flash.row_correction(o, do)


@jax.jit
def _jax_grads(q, k, v, valid, w):
    def loss(q, k, v):
        o = jax_flash(q, k, v, valid, SCALE)
        return jnp.sum(o.astype(jnp.float32) * w)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}-valid{s[2]}")
@pytest.mark.parametrize("dtype_name", DTYPES)
def test_split_emulation_matches_pallas(dtype_name, shape):
    tdtype, jdtype = DTYPES[dtype_name]
    arrays, valid = inputs(*shape, seed=shape[1])
    q, k, v, w = arrays
    ref = _jax_grads(*(jnp.asarray(a, jdtype) for a in (q, k, v)), jnp.asarray(valid),
                     jnp.asarray(w))
    got = emulate(*torch_operands(arrays, valid, tdtype), terms=2)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert b.dtype == jdtype
        np.testing.assert_allclose(
            a.to(tdtype).float().numpy(), np.asarray(b, np.float32), atol=JAX_ATOL, rtol=0,
            err_msg=name,
        )


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}-valid{s[2]}")
@pytest.mark.parametrize("dtype_name", DTYPES)
def test_split_stays_near_the_fp32_recurrence(dtype_name, shape):
    q, k, v, mask, do, lse, drow = torch_operands(*inputs(*shape, seed=shape[1] + 1),
                                                  DTYPES[dtype_name][0])
    up = [t.float() for t in (q, k, v, do)]
    ref = (torch_flash.flash_bwd_dq_plain(up[0], up[1], up[2], mask, up[3], lse, drow, SCALE),
           *torch_flash.flash_bwd_dkv_plain(up[0], up[1], up[2], mask, up[3], lse, drow, SCALE))
    assert all(r.dtype == torch.float32 for r in ref)
    two = emulate(q, k, v, mask, do, lse, drow, terms=2)
    one = emulate(q, k, v, mask, do, lse, drow, terms=1)
    for name, a2, a1, b in zip(("dq", "dk", "dv"), two, one, ref):
        assert rel(a2, b) <= SPLIT_REL, (name, rel(a2, b))
        assert rel(a1, b) > SPLIT_REL, (name, rel(a1, b))
    # Keys past the valid ones get exactly zero dk and dv.
    assert not two[1][:, shape[2]:].any() and not two[2][:, shape[2]:].any()
