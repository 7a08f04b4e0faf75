"""The CUDA kernels K1 (turboprune_tpu_torch/csrc/flash_fwd.cu) and K2/K3
(csrc/flash_bwd.cu) against their plain PyTorch versions, on the card.
Marked ``cuda``: skipped where there is no CUDA device; run on a GPU
machine with
``python -m pytest tests/test_torch_flash_cuda.py -m cuda``.

Tolerances: fp32 1e-5 (both sides accumulate in fp32, in other orders);
bf16/fp16 3e-2 as in tests/test_flash.py (o is rounded to the 16-bit type
after fp32 accumulations in different orders: an ulp or two apart). The
backward's fp32 gradients sum up to 384 terms of magnitude ~1 in other
orders: 1e-4; its 16-bit gradients are rounded once from those sums: 3e-2
absolute and relative, also at the edges of the 16-bit kernels' tiling;
and two launches give bit-identical gradients (no atomics).
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


@pytest.mark.parametrize(
    "dtype,tol",
    [(torch.float32, 1e-4), (torch.bfloat16, 3e-2), (torch.float16, 3e-2)],
)
@pytest.mark.parametrize("bh,seq,n_valid", [(96, 256, 197), (6, 384, 301)])
def test_backward_kernels_match_plain(cuda, dtype, tol, bh, seq, n_valid):
    got, ref = _backward(cuda, dtype, bh, seq, n_valid)
    for g, want in zip(got, ref):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), want.float(), atol=tol, rtol=tol)


def _backward(cuda, dtype, bh, seq, n_valid, seed=2):
    """K2/K3 on seeded inputs, with lse and drow from the plain forward:
    ((dq, dk, dv), flash_backward_plain's (dq, dk, dv))."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, do = (
        torch.randn(bh, seq, 64, device=cuda, generator=g).to(dtype) for _ in range(4)
    )
    valid = (torch.arange(seq, device=cuda) < n_valid).float()[None]
    with torch.no_grad():
        o, lse = flash.flash_attention_plain(q, k, v, valid, 0.125)
        drow = flash.row_correction(o, do)
        dq = flash.flash_bwd_dq_cuda(q, k, v, valid, do, lse, drow, 0.125)
        dk, dv = flash.flash_bwd_dkv_cuda(q, k, v, valid, do, lse, drow, 0.125)
        ref = flash.flash_backward_plain(q, k, v, valid, o, lse, do, 0.125)
    torch.cuda.synchronize()
    return (dq, dk, dv), ref


# Edges of the 16-bit kernels' tiling (64-row tiles, the streamed ones
# double-buffered): (b*h, seq, valid keys).
TILING_EDGES = {
    "seq128": (3, 128, 100),  # the shortest sequence: two tiles, one prefetch
    "all-keys-valid": (5, 256, 256),
    "one-valid-key": (6, 256, 1),
    "padding-query-tiles": (4, 256, 100),  # query and key tiles 128..255 wholly padding
    "bh13": (13, 384, 301),  # b*h prime, the last key tile partly valid
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("edge", TILING_EDGES)
def test_backward_kernels_tiling_edges(cuda, dtype, edge):
    bh, seq, n_valid = TILING_EDGES[edge]
    got, ref = _backward(cuda, dtype, bh, seq, n_valid, seed=3)
    for g, want in zip(got, ref):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), want.float(), atol=3e-2, rtol=3e-2)
    # Keys past the valid ones get exactly zero dk and dv (padded query rows
    # are not skipped: their dq is part of the function, held above).
    assert not got[1][:, n_valid:].any() and not got[2][:, n_valid:].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_backward_kernels_are_deterministic(cuda, dtype):
    first, _ = _backward(cuda, dtype, 96, 256, 197, seed=4)
    second, _ = _backward(cuda, dtype, 96, 256, 197, seed=4)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_kernel_refuses_what_it_does_not_run(cuda):
    q = torch.randn(2, 128, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention(q, q, q, torch.ones(1, 128, device=cuda), 0.5)
    # A CUDA tensor that requires grad runs K1 forward and K2/K3 backward,
    # and its gradients agree with the plain backward on the same inputs.
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (
        torch.randn(4, 128, 64, device=cuda, generator=g).requires_grad_()
        for _ in range(3)
    )
    valid = (torch.arange(128, device=cuda) < 77).float()[None]
    launches = [c.launches for c in (flash.flash_fwd_cuda, flash.flash_bwd_dq_cuda,
                                     flash.flash_bwd_dkv_cuda)]
    out = flash.flash_attention(q, k, v, valid, 0.125)
    w = torch.randn(out.shape, device=cuda, generator=g)
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert [c.launches for c in (flash.flash_fwd_cuda, flash.flash_bwd_dq_cuda,
                                 flash.flash_bwd_dkv_cuda)] == [n + 1 for n in launches]
    with torch.no_grad():
        o, lse = flash.flash_attention_plain(q, k, v, valid, 0.125)
        ref = flash.flash_backward_plain(q, k, v, valid, o, lse, w, 0.125)
    for got, want in zip(grads, ref):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_backward_kernels_take_misaligned_row_vectors(cuda):
    # lse, drow and the validity row as views 4 bytes past a 16-byte
    # boundary: the 16-bit kernels copy them by 16-byte cp.async, so the
    # wrappers hand them aligned copies, and the gradients do not change.
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (
        torch.randn(6, 128, 64, device=cuda, generator=g).to(torch.bfloat16)
        for _ in range(4)
    )
    valid = (torch.arange(128, device=cuda) < 100).float()[None]

    def off16(t):
        view = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        return view

    with torch.no_grad():
        o, lse = flash.flash_attention_plain(q, k, v, valid, 0.125)
        drow = flash.row_correction(o, do)
        args = (q, k, v, valid, do, lse, drow, 0.125)
        shifted = (q, k, v, off16(valid), do, off16(lse), off16(drow), 0.125)
        want = (flash.flash_bwd_dq_cuda(*args), *flash.flash_bwd_dkv_cuda(*args))
        got = (flash.flash_bwd_dq_cuda(*shifted), *flash.flash_bwd_dkv_cuda(*shifted))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
