"""The CUDA kernel K1 (turboprune_tpu_torch/csrc/flash_fwd.cu) against its
plain PyTorch version, on the card. Marked ``cuda``: skipped where there is
no CUDA device; run on a GPU machine with
``python -m pytest tests/test_torch_flash_cuda.py -m cuda``.

Tolerances: fp32 1e-5 (both sides accumulate in fp32, in other orders);
bf16/fp16 3e-2 as in tests/test_flash.py (o is rounded to the 16-bit type
after fp32 accumulations in different orders: an ulp or two apart).
"""

import pytest
import torch

from turboprune_tpu_torch.ops import flash

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "dtype,tol",
    [(torch.float32, 1e-5), (torch.bfloat16, 3e-2), (torch.float16, 3e-2)],
)
@pytest.mark.parametrize("bh,seq,n_valid", [(768, 256, 197), (4, 128, 77), (6, 384, 300)])
def test_kernel_matches_plain(cuda, dtype, tol, bh, seq, n_valid):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (
        torch.randn(bh, seq, 64, device=cuda, generator=g).to(dtype) for _ in range(3)
    )
    valid = (torch.arange(seq, device=cuda) < n_valid).float()[None]
    before = flash.flash_fwd_cuda.launches
    with torch.no_grad():
        o, lse = flash.flash_fwd_cuda(q, k, v, valid, 0.125)
        ref_o, ref_lse = flash.flash_attention_plain(q, k, v, valid, 0.125)
    torch.cuda.synchronize()
    assert flash.flash_fwd_cuda.launches == before + 1
    torch.testing.assert_close(o.float(), ref_o.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


def test_kernel_refuses_what_it_does_not_run(cuda):
    q = torch.randn(2, 128, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention(q, q, q, torch.ones(1, 128, device=cuda), 0.5)
    q = torch.randn(2, 128, 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K2/K3"):
        flash.flash_attention(q, q, q, torch.ones(1, 128, device=cuda), 0.125)
