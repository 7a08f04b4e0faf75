"""The 16-bit flash forward kernel's recurrence (K1, csrc/flash_fwd.cu),
emulated in torch on the CPU.

K1 walks the keys in blocks of 128, the TPU kernel's online-softmax unit,
and computes each block only up to its last 16-key group that holds a valid
key; a block with no valid key is skipped whole. Within a computed block the
scores come from 16-bit operands in fp32, times the scale; padded keys are
masked to -1e30 before the block max; p = exp(s - m_new) is 0 for them; l
adds the fp32 p; p is rounded to the input dtype before an fp32-accumulated
PV. At the end m is taken as max(m, -1e30), so that a row with no valid key
ends with the TPU's lse = -1e30 (skipping every block would leave -inf).

The emulation below runs that recurrence on numpy-seeded inputs, over
validity rows that reach every branch of it: a prefix (197 of 256), holes
with a dead 16-key group inside a block and at its end, a first block with
no valid key, a middle block with none, and no valid key at all. It is held

- against the JAX package's ``flash_attention`` (Pallas in interpret mode on
  the CPU, as tests/test_flash.py runs it), within that file's tolerances
  (1e-5 in fp32, 3e-2 in bf16/fp16), lse too;
- against ``flash_attention_plain``, the port's TPU recurrence over whole
  blocks: in fp32 within 1e-6 (only sums over exact zeros differ); in
  bf16/fp16 within chip_smoke.py's 2-ulp rule (2 ulps of the dtype at
  max(|o|, 0.1)), with at most 1% of the elements differing at all; lse
  within 1e-6. The 1% tells the rescale unit apart: the same recurrence
  rescaling per 64 keys rounds every p against another max and differs from
  the plain version in more than 5% of the elements at these inputs.

With no valid key, lse must be the JAX side's -1e30 and
``flash_backward_plain`` fed it finite gradients; without the final clamp it
would be -inf and the gradients NaN. And K1 writes o = acc / l as the
product with r = 1 / l corrected by one FMA, which is the correctly rounded
quotient (the bare product is not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)
from turboprune_tpu.ops.flash import _fa_fwd as jax_flash_fwd
from turboprune_tpu_torch.ops import flash as torch_flash

SCALE = 0.125  # 1 / sqrt(64)
BLOCK = 128  # keys per online-softmax block
GROUP = 16  # keys per group of the kernel's skipping
NEG_BIG = -1e30
BH = 3
JAX_ATOL = {"fp32": 1e-5, "bf16": 3e-2, "fp16": 3e-2}  # tests/test_flash.py's
DTYPES = {
    "fp32": (torch.float32, jnp.float32),
    "bf16": (torch.bfloat16, jnp.bfloat16),
    "fp16": (torch.float16, jnp.float16),
}
MANTISSA_BITS = {"bf16": 8, "fp16": 11}  # significant bits, the implicit one included


def _holes() -> np.ndarray:
    keep = np.random.default_rng(7).random(256) < 0.6
    keep[32:48] = False  # a dead 16-key group inside the first block
    keep[240:] = False  # and the second block's last group
    return keep


# name -> (validity row, key rows the kernel loads and computes)
VALIDITY = {
    "prefix-197": (np.arange(256) < 197, 128 + 80),
    "holes": (_holes(), 128 + 112),
    "dead-first-block": ((np.arange(256) >= 128) & (np.arange(256) < 201), 80),
    "dead-middle-block": (
        (np.arange(384) < 100) | ((np.arange(384) >= 256) & (np.arange(384) < 301)),
        112 + 48,
    ),
    "no-valid-key": (np.zeros(256, bool), 0),
}


def emulate(q, k, v, valid, clamp=True, block=BLOCK):
    """K1's recurrence: (o in q's dtype, lse [bh, seq, 1] fp32, key rows
    computed). ``clamp=False`` leaves out the final max(m, -1e30); another
    ``block`` rescales per that many keys."""
    ok = valid.reshape(-1) > 0
    bh, seq, d = q.shape
    m = torch.full((bh, seq, 1), float("-inf"))
    l = torch.zeros((bh, seq, 1))
    acc = torch.zeros((bh, seq, d))
    computed = 0
    for k0 in range(0, seq, block):
        live = torch.nonzero(ok[k0 : k0 + block])
        if not len(live):
            continue  # no valid key: neither loaded nor computed
        n = (int(live[-1]) // GROUP + 1) * GROUP  # up to the last live group
        blk = slice(k0, k0 + n)
        computed += n
        s = (q.float() @ k[:, blk].float().transpose(1, 2)) * SCALE
        s = torch.where(ok[blk], s, NEG_BIG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(ok[blk], torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ v[:, blk].float()
        m = m_new
    if clamp:
        m = torch.clamp_min(m, NEG_BIG)
    lsafe = torch.clamp_min(l, 1e-30)
    return (acc / lsafe).to(q.dtype), m + torch.log(lsafe), computed


def inputs(case, dtype_name, seed=0):
    """q, k, v (numpy fp32, then in the dtype for torch), the validity row
    [1, seq] (numpy fp32) and the key rows K1 computes."""
    keep, rows = VALIDITY[case]
    rng = np.random.default_rng(seed + len(keep))
    arrays = [rng.normal(size=(BH, len(keep), 64)).astype(np.float32) for _ in range(3)]
    valid = keep.astype(np.float32)[None]
    tdtype = DTYPES[dtype_name][0]
    return arrays, [torch.from_numpy(a).to(tdtype) for a in arrays], valid, rows


@jax.jit
def _jax_forward(q, k, v, valid):
    o, residuals = jax_flash_fwd(q, k, v, valid, SCALE, BLOCK, BLOCK, None)
    return o, residuals[5]  # (o, lse)


def _two_ulps(ref: torch.Tensor, dtype_name: str) -> torch.Tensor:
    """chip_smoke.py's limit: 2 ulps of the dtype at max(|o|, 0.1)."""
    _, e = torch.frexp(ref.float().abs().clamp_min(0.1))
    return 2 * torch.ldexp(torch.ones_like(ref, dtype=torch.float32),
                           e - MANTISSA_BITS[dtype_name])


@pytest.mark.parametrize("case", VALIDITY)
@pytest.mark.parametrize("dtype_name", DTYPES)
def test_emulation_matches_pallas(dtype_name, case):
    arrays, (q, k, v), valid, _ = inputs(case, dtype_name)
    jdtype = DTYPES[dtype_name][1]
    ref_o, ref_lse = _jax_forward(*(jnp.asarray(a, jdtype) for a in arrays),
                                  jnp.asarray(valid))
    o, lse, _ = emulate(q, k, v, torch.from_numpy(valid))
    assert ref_o.dtype == jdtype and o.dtype == q.dtype
    np.testing.assert_allclose(o.float().numpy(), np.asarray(ref_o, np.float32),
                               atol=JAX_ATOL[dtype_name], rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", VALIDITY)
@pytest.mark.parametrize("dtype_name", DTYPES)
def test_emulation_matches_plain(dtype_name, case):
    _, (q, k, v), valid, rows = inputs(case, dtype_name, seed=1)
    mask = torch.from_numpy(valid)
    o, lse, computed = emulate(q, k, v, mask)
    ref_o, ref_lse = torch_flash.flash_attention_plain(q, k, v, mask, SCALE)
    assert computed == rows
    diff = (o.float() - ref_o.float()).abs()
    if dtype_name == "fp32":
        assert diff.max().item() <= 1e-6, diff.max().item()
    else:
        share = (diff / _two_ulps(ref_o, dtype_name)).max().item()
        assert share <= 1.0, share
        assert (diff > 0).float().mean().item() <= 0.01
    assert (lse - ref_lse).abs().max().item() <= 1e-6


@pytest.mark.parametrize("dtype_name", ["bf16", "fp16"])
def test_no_valid_key_gives_the_tpu_lse_and_finite_gradients(dtype_name):
    arrays, (q, k, v), valid, _ = inputs("no-valid-key", dtype_name, seed=2)
    mask = torch.from_numpy(valid)
    jdtype = DTYPES[dtype_name][1]
    _, ref_lse = _jax_forward(*(jnp.asarray(a, jdtype) for a in arrays), jnp.asarray(valid))
    o, lse, _ = emulate(q, k, v, mask)
    assert not o.any()
    np.testing.assert_array_equal(lse.numpy(), np.asarray(ref_lse))
    assert (lse == NEG_BIG).all()
    do = torch.from_numpy(np.random.default_rng(3).normal(size=o.shape).astype(np.float32))
    grads = torch_flash.flash_backward_plain(q, k, v, mask, o, lse, do.to(q.dtype), SCALE)
    assert all(bool(g.float().isfinite().all()) for g in grads)
    # Without the clamp every block is skipped and m stays -inf: the
    # backward's exp(s - lse) * 0 is then inf * 0.
    _, lse_inf, _ = emulate(q, k, v, mask, clamp=False)
    assert torch.isneginf(lse_inf).all()
    grads = torch_flash.flash_backward_plain(q, k, v, mask, o, lse_inf, do.to(q.dtype), SCALE)
    assert not bool(grads[0].float().isfinite().all())


@pytest.mark.parametrize("dtype_name", ["bf16", "fp16"])
def test_a_64_key_rescale_rounds_another_function(dtype_name):
    # What the 1% of test_emulation_matches_plain separates.
    _, (q, k, v), valid, _ = inputs("prefix-197", dtype_name, seed=1)
    mask = torch.from_numpy(valid)
    o64, _, _ = emulate(q, k, v, mask, block=64)
    ref_o, _ = torch_flash.flash_attention_plain(q, k, v, mask, SCALE)
    assert ((o64.float() - ref_o.float()).abs() > 0).float().mean().item() > 0.05


def test_corrected_reciprocal_is_the_rounded_quotient():
    # K1's quotient(a, b, r): q = a r with r = 1 / b, then q + (a - q b) r,
    # each step rounded to fp32 once. float64 holds a - q b exactly (the
    # FMA's residual) and r times it exactly.
    rng = np.random.default_rng(5)
    a = (rng.normal(size=1_000_000) * 3).astype(np.float32)  # acc
    b = np.exp(rng.uniform(0.0, np.log(300.0), size=a.size)).astype(np.float32)  # l
    r = np.float32(1.0) / b
    q = a * r
    residual = (a.astype(np.float64) - q.astype(np.float64) * b).astype(np.float32)
    fixed = (q + residual.astype(np.float64) * r).astype(np.float32)
    assert np.array_equal(fixed, a / b)
    assert not np.array_equal(q, a / b)
