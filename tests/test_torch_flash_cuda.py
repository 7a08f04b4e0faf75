"""The CUDA kernels K1 (turboprune_tpu_torch/csrc/flash_fwd.cu) and K2/K3
(csrc/flash_bwd.cu) against their plain PyTorch versions, on the card.
Marked ``cuda``: skipped where there is no CUDA device; run on a GPU
machine with
``python -m pytest tests/test_torch_flash_cuda.py -m cuda``.

Tolerances: fp32 1e-5 (both sides accumulate in fp32, in other orders);
bf16/fp16 3e-2 as in tests/test_flash.py (o is rounded to the 16-bit type
after fp32 accumulations in different orders: an ulp or two apart), lse
1e-4. The 16-bit K1 skips dead 16-key groups and key blocks with no valid
key: it is also held on validity rows with holes and dead blocks, at valid
counts on the edges of its groups and blocks, with no valid key at all
(o = 0 and the TPU's lse = -1e30, from which the backward stays finite),
and for bit-identical results across two launches. The
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


def _forward(cuda, dtype, bh, valid, seed):
    """K1 and the plain forward on seeded inputs: (q, k, v, o, lse, ref_o,
    ref_lse)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (
        torch.randn(bh, valid.shape[1], 64, device=cuda, generator=g).to(dtype)
        for _ in range(3)
    )
    with torch.no_grad():
        o, lse = flash.flash_fwd_cuda(q, k, v, valid, 0.125)
        ref_o, ref_lse = flash.flash_attention_plain(q, k, v, valid, 0.125)
    torch.cuda.synchronize()
    return q, k, v, o, lse, ref_o, ref_lse


# Validity rows K1 skips work on: name -> (seq, valid keys as a bool row).
def _rows(seq, *ranges):
    keep = torch.zeros(seq, dtype=torch.bool)
    for a, b in ranges:
        keep[a:b] = True
    return keep


VALIDITY_ROWS = {
    "holes": lambda: _rows(256, (0, 20), (48, 60), (61, 118), (130, 131), (150, 230)),
    "dead-first-block": lambda: _rows(256, (128, 201)),
    "dead-middle-block": lambda: _rows(384, (0, 100), (256, 301)),
    "alternate": lambda: (torch.arange(256) % 2 == 1),
}
TOLS = {torch.float32: 1e-5, torch.bfloat16: 3e-2, torch.float16: 3e-2}
DTYPE_IDS = {torch.float32: "fp32", torch.bfloat16: "bf16", torch.float16: "fp16"}


@pytest.mark.parametrize("dtype", TOLS, ids=DTYPE_IDS.get)
@pytest.mark.parametrize("rows", VALIDITY_ROWS)
def test_kernel_matches_plain_on_validity_rows(cuda, dtype, rows):
    valid = VALIDITY_ROWS[rows]().float()[None].to(cuda)
    *_, o, lse, ref_o, ref_lse = _forward(cuda, dtype, 24, valid, seed=6)
    torch.testing.assert_close(o.float(), ref_o.float(), atol=TOLS[dtype], rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", TOLS, ids=DTYPE_IDS.get)
def test_kernel_with_no_valid_key(cuda, dtype):
    # Every block is skipped: o = 0 and lse = -1e30, as the TPU kernel
    # ends (m = max(-inf, -1e30)); the backward from that lse stays finite.
    valid = torch.zeros(1, 256, device=cuda)
    q, k, v, o, lse, ref_o, ref_lse = _forward(cuda, dtype, 12, valid, seed=7)
    assert not o.any()
    assert bool((lse == flash.NEG_BIG).all()) and bool((ref_lse == flash.NEG_BIG).all())
    do = torch.randn_like(q)
    with torch.no_grad():
        drow = flash.row_correction(o, do)
        grads = (flash.flash_bwd_dq_cuda(q, k, v, valid, do, lse, drow, 0.125),
                 *flash.flash_bwd_dkv_cuda(q, k, v, valid, do, lse, drow, 0.125),
                 *flash.flash_backward_plain(q, k, v, valid, o, lse, do, 0.125))
    torch.cuda.synchronize()
    for g in grads:
        assert bool(g.float().isfinite().all()) and not g.any()


# Valid counts (a prefix) on the edges of K1's 16-key groups and 128-key
# blocks: (seq, valid keys).
GROUP_EDGES = [(256, n) for n in (1, 16, 17, 127, 128, 129, 255, 256)] + [(384, 301)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("seq,n_valid", GROUP_EDGES)
def test_kernel_group_and_block_edges(cuda, dtype, seq, n_valid):
    valid = (torch.arange(seq, device=cuda) < n_valid).float()[None]
    *_, o, lse, ref_o, ref_lse = _forward(cuda, dtype, 10, valid, seed=8)
    torch.testing.assert_close(o.float(), ref_o.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_kernel_is_deterministic(cuda, dtype):
    valid = (torch.arange(256, device=cuda) < 197).float()[None]
    q, k, v, o, lse, *_ = _forward(cuda, dtype, 96, valid, seed=9)
    with torch.no_grad():
        o2, lse2 = flash.flash_fwd_cuda(q, k, v, valid, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    # The CUDA path refuses a block_k it would not honour.
    with pytest.raises(ValueError, match="128"):
        flash.flash_attention(q, k, v, valid, 0.125, 128, 64)


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
