"""The compiled step on the card: inductor under CUDA graphs
(``train.compile_forward`` on a CUDA device) against the eager step, for
ResNet-18 (CIFAR stem, BatchNorm statistics updated in place inside the
graph) and a 2-block DeiT with flash attention (K1-K3 as custom ops inside
the graph), and the custom ops' CUDA routes inside a captured CUDA graph
against their plain versions. Marked ``cuda``: skipped where there is no
CUDA device; run on a GPU machine with
``python -m pytest tests/test_torch_compile_cuda.py -m cuda --noconftest``.

Tolerances. fp32 with TF32 off: inductor fuses the elementwise work and
reorders the BatchNorm and LayerNorm reductions, so values differ by fp32
rounding of reordered sums: logits within 1e-4 of their largest, the
running statistics within 1e-4 of theirs (as the card against the CPU in
chip_smoke.py); gradients: the whole gradient within 2e-3 of its norm
(a BatchNorm in train mode makes its scale and bias gradients small sums
of large terms, ~1e-3 of fp32 noise each way, PERF.md), the DeiT's
within 1e-4. Inside a captured graph the custom ops run the same kernels
on the same inputs as eagerly: equal bit for bit.
"""

import pytest
import torch

from turboprune_tpu_torch.models import create_model
from turboprune_tpu_torch.models import vit as tvit
from turboprune_tpu_torch.ops import flash, masking
from turboprune_tpu_torch.train import compile_forward, mark_buffers_static, train_forward

pytestmark = pytest.mark.cuda

LOGIT_REL = 1e-4
STAT_REL = 1e-4
RESNET_GRAD_REL = 2e-3
DEIT_GRAD_REL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (inductor's CUDA graphs and the kernels)")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _step(model, masks, images, labels, forward):
    """Logits, running statistics and parameter gradients of one train
    step's loss through ``forward``."""
    model.train()
    out = forward(model, masks, images, labels)
    params = list(model.parameters())
    grads = torch.autograd.grad(out["loss"], params)
    torch.cuda.synchronize()
    return (out["logits"].float().clone(), [b.clone() for b in model.buffers()],
            [g.float().clone() for g in grads])


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _compare(make, image, cuda, grad_rel):
    from torch._dynamo.utils import counters

    g = torch.Generator().manual_seed(0)
    eager_model = make().init_weights(g).to(cuda)
    compiled_model = make().to(cuda)
    compiled_model.load_state_dict(eager_model.state_dict())
    mark_buffers_static(compiled_model)
    masks = {p: (torch.rand(m.shape, generator=g) < 0.7).to(cuda)
             for p, m in masking.make_masks(eager_model).items()}
    images = torch.randn(16, image, image, 3, generator=g).to(cuda)
    labels = torch.randint(0, 10, (16,), generator=g).to(cuda)
    skips = counters["inductor"]["cudagraph_skips"]
    forward = compile_forward(train_forward, cuda)
    # Warm-up, recording, then a replay, each from the same weights: the
    # statistics move in both models alike, so they are reset each time.
    stats = [b.clone() for b in eager_model.buffers()]
    for _ in range(3):
        for b, s in zip(compiled_model.buffers(), stats):
            b.copy_(s)
        got = _step(compiled_model, masks, images, labels, forward)
    want = _step(eager_model, masks, images, labels, train_forward)
    assert counters["inductor"]["cudagraph_skips"] == skips
    logits, bufs, grads = got
    w_logits, w_bufs, w_grads = want
    assert float((logits - w_logits).abs().max() / w_logits.abs().max()) <= LOGIT_REL
    for b, w in zip(bufs, w_bufs):
        assert float((b - w).abs().max() / w.abs().max()) <= STAT_REL
    whole = _rel(torch.cat([x.reshape(-1) for x in grads]),
                 torch.cat([x.reshape(-1) for x in w_grads]))
    assert whole <= grad_rel


def test_compiled_resnet18_step_matches_eager(cuda):
    _compare(lambda: create_model("resnet18", 10, "CIFAR10"), 32, cuda, RESNET_GRAD_REL)


def test_compiled_flash_deit_step_matches_eager_through_the_kernels(cuda):
    def make():
        return tvit.VisionTransformer(num_classes=10, patch_size=16, embed_dim=128, depth=2,
                                      num_heads=2, image_size=32, attention_impl="flash")

    before = flash.flash_fwd_cuda.launches
    _compare(make, 32, cuda, DEIT_GRAD_REL)
    assert flash.flash_fwd_cuda.launches > before  # eager, warm-up and recording


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_inside_a_captured_cuda_graph(cuda, dtype):
    """K1, then K2 and K3 fed its o and lse, captured into one CUDA graph
    and replayed on new inputs copied into the captured ones: each equals
    the same op run eagerly on those inputs, and the launch counters move
    at capture only (no Python runs in a replay)."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def inputs():
        return [torch.randn(12, 256, 64, device=cuda, generator=g).to(dtype) for _ in range(4)]

    valid = (torch.arange(256, device=cuda) < 197)[None]
    ops = torch.ops.turboprune_tpu_torch

    def run(q, k, v, do):
        o, lse = ops.flash_fwd(q, k, v, valid, 0.125, 128, 128)
        drow = flash.row_correction(o, do)
        dq = ops.flash_bwd_dq(q, k, v, valid, do, lse, drow, 0.125, 128)
        dk, dv = ops.flash_bwd_dkv(q, k, v, valid, do, lse, drow, 0.125, 128)
        return o, lse, dq, dk, dv

    static = inputs()
    run(*static)  # warm-up: the libraries load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run(*static)
    counts = (flash.flash_fwd_cuda.launches, flash.flash_bwd_dq_cuda.launches,
              flash.flash_bwd_dkv_cuda.launches)
    for _ in range(2):
        fresh = inputs()
        for s, f in zip(static, fresh):
            s.copy_(f)
        graph.replay()
        want = run(*fresh)
        torch.cuda.synchronize()
        for got, ref in zip(outs, want):
            assert torch.equal(got, ref)
    # The eager calls above count; the replays do not.
    assert flash.flash_fwd_cuda.launches == counts[0] + 2
    assert flash.flash_bwd_dq_cuda.launches == counts[1] + 2
    assert flash.flash_bwd_dkv_cuda.launches == counts[2] + 2
    # And the kernels agree with their plain versions on the last inputs.
    q, k, v, do = fresh
    ref_o, ref_lse = flash.flash_attention_plain(q, k, v, valid, 0.125)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(outs[0].float(), ref_o.float(), atol=tol, rtol=0)
    torch.testing.assert_close(outs[1], ref_lse, atol=1e-4, rtol=0)
