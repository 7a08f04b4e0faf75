"""Port of the flash-attention forward (turboprune_tpu_torch/ops/flash.py)
against the JAX Pallas kernel, run in interpret mode on the CPU as
tests/test_flash.py runs it.

Same numpy inputs go through both; tolerances are those of
tests/test_flash.py: 1e-5 in fp32, 3e-2 in bf16 (one bf16 ulp at the
output's magnitude is ~4e-3; the two sides may round p and o at different
summation orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from turboprune_tpu.ops.flash import flash_attention as jax_flash
from turboprune_tpu_torch.ops import flash as torch_flash


def make_qkv(bh=4, s=16, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(bh, s, d)).astype(np.float32) for _ in range(3))


def run_both(q, k, v, valid, scale, bq, bk, jdtype=jnp.float32, tdtype=torch.float32):
    ref = jax_flash(
        *(jnp.asarray(t, jdtype) for t in (q, k, v)),
        jnp.asarray(valid), scale, bq, bk,
    )
    out = torch_flash.flash_attention(
        *(torch.from_numpy(t).to(tdtype) for t in (q, k, v)),
        torch.from_numpy(valid), scale, bq, bk,
    )
    return np.asarray(ref, np.float32), out.float().numpy(), out


class TestPlainMatchesPallas:
    @pytest.mark.parametrize("blocks", [(16, 16), (8, 8), (16, 8), (8, 16)])
    def test_fp32_blocks(self, blocks):
        q, k, v = make_qkv()
        valid = np.ones((1, 16), np.float32)
        ref, out, _ = run_both(q, k, v, valid, 0.35, *blocks)
        np.testing.assert_allclose(out, ref, atol=1e-5)

    def test_padding_masked(self):
        q, k, v = make_qkv(s=16, seed=3)
        valid = np.asarray([[1.0] * 11 + [0.0] * 5], np.float32)
        ref, out, _ = run_both(q, k, v, valid, 0.5, 8, 8)
        np.testing.assert_allclose(out, ref, atol=1e-5)

    def test_fully_masked_key_block(self):
        # The second key block holds no valid key: its p must be exactly 0
        # and the running max must not move.
        q, k, v = make_qkv(s=16, seed=4)
        valid = np.asarray([[1.0] * 5 + [0.0] * 11], np.float32)
        ref, out, _ = run_both(q, k, v, valid, 0.5, 8, 8)
        np.testing.assert_allclose(out, ref, atol=1e-5)

    def test_bf16_inputs(self):
        q, k, v = make_qkv(seed=1)
        valid = np.ones((1, 16), np.float32)
        ref, out, raw = run_both(
            q, k, v, valid, 0.35, 8, 8, jnp.bfloat16, torch.bfloat16
        )
        assert raw.dtype == torch.bfloat16
        np.testing.assert_allclose(out, ref, atol=3e-2)

    def test_lse_is_row_logsumexp(self):
        q, k, v = make_qkv(seed=2)
        valid = np.asarray([[1.0] * 13 + [0.0] * 3], np.float32)
        tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
        _, lse = torch_flash.flash_attention_plain(
            tq, tk, tv, torch.from_numpy(valid), 0.4, 8, 8
        )
        s = (tq @ tk.transpose(1, 2)) * 0.4
        s = s.masked_fill(~torch.from_numpy(valid[0] > 0), float("-inf"))
        torch.testing.assert_close(
            lse[..., 0], torch.logsumexp(s, -1), atol=1e-5, rtol=0
        )


class TestContract:
    def test_rejects_undivisible_seq_and_batched_mask(self):
        q, k, v = (torch.from_numpy(t) for t in make_qkv(s=20))
        with pytest.raises(ValueError, match="multiple"):
            torch_flash.flash_attention(q, k, v, torch.ones(1, 20), 0.5, 16, 16)
        q, k, v = (torch.from_numpy(t) for t in make_qkv(s=16))
        with pytest.raises(ValueError, match="kv_valid"):
            torch_flash.flash_attention(q, k, v, torch.ones(4, 16), 0.5, 8, 8)

    def test_cpu_takes_the_plain_version_without_launching(self):
        before = torch_flash.flash_fwd_cuda.launches
        q, k, v = (torch.from_numpy(t) for t in make_qkv())
        torch_flash.flash_attention(q, k, v, torch.ones(1, 16), 0.5, 8, 8)
        assert torch_flash.flash_fwd_cuda.launches == before

    def test_cuda_path_refuses_a_block_k_the_kernel_does_not_run(self):
        # K1 rescales per 128 keys; FlashAttention checks block_k before it
        # launches K1 on a CUDA tensor, instead of ignoring it.
        torch_flash.check_kernel_block_k(128)
        for block_k in (64, 256):
            with pytest.raises(ValueError, match="per 128 keys"):
                torch_flash.check_kernel_block_k(block_k)

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        q, k, v = (torch.from_numpy(t) for t in make_qkv())
        with pytest.raises(ValueError, match="CUDA tensors"):
            torch_flash.flash_fwd_cuda(q, k, v, torch.ones(1, 16), 0.5)
