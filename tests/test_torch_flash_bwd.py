"""Gradients of the port's flash attention on the CPU (the autograd function
over ``flash_backward_plain``) against ``jax.grad`` of the JAX package's
``flash_attention``, whose backward is the Pallas kernels K2/K3 run in
interpret mode on the CPU, as tests/test_flash.py runs them.

Same numpy inputs and the same upstream cotangent go through both.
Tolerances: fp32 grads atol 2e-4, rtol 1e-4, those of tests/test_flash.py
(both sides run the same fp32 recurrences, in other summation orders).
bf16: rtol 2^-7, atol 2^-10 — one bf16 ulp of the element, at most: both
sides take the same fp32 sums from the same bf16 inputs and round each
gradient to bf16 once, so they may differ by a rounding flip of the output
and of the forward's o (which enters drow).
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

SEQ = 16
SCALE = 0.35
FULL = [1.0] * SEQ
PADDED = [1.0] * 11 + [0.0] * 5
KEY_BLOCK_MASKED = [1.0] * 5 + [0.0] * 11  # at block 8, keys 8..15 all invalid


@functools.partial(jax.jit, static_argnums=5)
def _jax_grads(q, k, v, valid, w, blocks):
    def loss(q, k, v):
        o = jax_flash(q, k, v, valid, SCALE, *blocks)
        return jnp.sum(o.astype(jnp.float32) * w)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def jax_grads(q, k, v, valid, w, blocks, jdtype):
    """jax.grad of sum(o * w) in q, k, v: one compile per (dtype, blocks)."""
    return _jax_grads(
        *(jnp.asarray(t, jdtype) for t in (q, k, v)), jnp.asarray(valid),
        jnp.asarray(w), blocks,
    )


def torch_grads(q, k, v, valid, w, blocks, tdtype):
    tq, tk, tv = (torch.from_numpy(t).to(tdtype).requires_grad_() for t in (q, k, v))
    mask = torch.tensor(valid, requires_grad=True)
    out = torch_flash.flash_attention(tq, tk, tv, mask, SCALE, *blocks)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert mask.grad is None  # the mask gets no gradient
    assert all(t.grad.dtype == tdtype for t in (tq, tk, tv))
    return [t.grad.float().numpy() for t in (tq, tk, tv)]


def inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(4, SEQ, 8)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize(
    "blocks,valid,seed",
    [
        ((8, 8), FULL, 0),
        ((16, 8), FULL, 1),
        ((8, 8), PADDED, 2),
        ((16, 8), PADDED, 3),
        ((8, 8), KEY_BLOCK_MASKED, 4),
    ],
    ids=["b8x8", "b16x8", "b8x8-padded", "b16x8-padded", "b8x8-masked-key-block"],
)
def test_fp32_grads_match_pallas(blocks, valid, seed):
    q, k, v, w = inputs(seed)
    valid = np.asarray([valid], np.float32)
    ref = jax_grads(q, k, v, valid, w, blocks, jnp.float32)
    got = torch_grads(q, k, v, valid, w, blocks, torch.float32)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=1e-4, err_msg=f"d{name}")
    if valid[0, 8:].sum() == 0:
        # Keys of a fully masked block get exactly zero gradient.
        assert not got[1][:, 8:].any() and not got[2][:, 8:].any()


def test_bf16_grads_match_pallas():
    q, k, v, w = inputs(5)
    valid = np.asarray([PADDED], np.float32)
    ref = jax_grads(q, k, v, valid, w, (8, 8), jnp.bfloat16)
    got = torch_grads(q, k, v, valid, w, (8, 8), torch.bfloat16)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(
            a, np.asarray(b, np.float32), rtol=2**-7, atol=2**-10, err_msg=f"d{name}"
        )


def test_cpu_backward_launches_no_kernel():
    counters = [torch_flash.flash_fwd_cuda, torch_flash.flash_bwd_dq_cuda,
                torch_flash.flash_bwd_dkv_cuda]
    before = [c.launches for c in counters]
    q, k, v, w = inputs(6)
    torch_grads(q, k, v, np.ones((1, SEQ), np.float32), w, (8, 8), torch.float32)
    assert [c.launches for c in counters] == before


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, do = (torch.from_numpy(t) for t in inputs(7))
    stat = torch.zeros(4, SEQ, 1)
    valid = torch.ones(1, SEQ)
    with pytest.raises(ValueError, match="CUDA tensors"):
        torch_flash.flash_bwd_dq_cuda(q, k, v, valid, do, stat, stat, SCALE)
    with pytest.raises(ValueError, match="CUDA tensors"):
        torch_flash.flash_bwd_dkv_cuda(q, k, v, valid, do, stat, stat, SCALE)


def test_plain_backward_keeps_the_validation_contract():
    q, k, v, do = (torch.from_numpy(t) for t in inputs(8))
    o, lse = torch_flash.flash_attention_plain(q, k, v, torch.ones(1, SEQ), SCALE, 8, 8)
    with pytest.raises(ValueError, match="multiple"):
        torch_flash.flash_backward_plain(q, k, v, torch.ones(1, SEQ), o, lse, do, SCALE, 8, 5)
    with pytest.raises(ValueError, match="kv_valid"):
        torch_flash.flash_backward_plain(q, k, v, torch.ones(4, SEQ), o, lse, do, SCALE, 8, 8)
