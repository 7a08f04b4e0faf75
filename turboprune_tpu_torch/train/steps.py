"""Train and eval steps (port of ``turboprune_tpu/train/steps.py``).

A step's model work is one function of (model, masks, images, labels):
``train_forward`` (forward with the masks multiplied into the weights
inside it, so the gradient is taken with respect to the RAW params: masked
weights get zero data-gradient but still move under weight decay and
momentum, the reference's semantics; summed cross entropy in fp32; the
``correct`` count) and ``eval_forward`` (the same sums with padded rows
excluded). Attention with ``attention_impl: flash`` runs K1 forward and
K2/K3 backward on CUDA.

By default the step calls them eagerly from a Python loop. With
``model_params.use_compile`` the harness hands the step their compiled
versions (``compile_forward``): the counterpart of the JAX package's
``make_scan_epoch``/``make_scan_chunk``/``make_scan_eval``, as the
reference's ``torch.compile(model, mode="reduce-overhead")``. On CUDA that
is inductor under CUDA graphs, so a step's forward and its AOTAutograd
backward are each one graph replay with no per-kernel host dispatch. What
stays eager either way: the backward call, ``optimizer.step()`` (foreach
SGD or AdamW, or schedule-free SGD), ``set_lr`` (a Python float that must
not become a graph constant) and the step counter.

Dropout (VGG's classifier, a ViT with a rate) draws from no global
generator: the harness owns a ``DropoutNoise`` (one ``torch.Generator``
on the device), which each train step reseeds from (seed, step), the
counterpart of the JAX step's ``fold_in(state.rng, state.step)``, and
draws the step's uniforms from eagerly; the forward takes them as a tensor
argument (``models/dropout.py``), in the eager and the compiled step alike.

Metrics are SUMS (``loss_sum``, ``correct``, ``count``) kept on the device;
the harness adds them up over an epoch (``add_sums``, into tensors no graph
owns) and reads them once at its end.

Data parallel (``mesh``, a ``parallel.Mesh`` whose data axis has more than
one rank): each rank steps on its rows of the global batch, and the step
replaces every gradient by its mean over the data group
(``parallel.average_gradients``) between ``backward()`` and
``optimizer.step()``, the counterpart of the psum XLA inserts into the JAX
package's sharded step. Dropout's uniforms are drawn for the whole global
batch and the rank takes its rows, so a world of two draws what a world of
one draws. In a world of one nothing of this runs.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..models.dropout import draw_dropout_noise, dropout_shapes
from ..ops.masking import Masks, apply_masks
from ..parallel import Mesh, average_gradients
from .optim import set_lr
from .state import TrainState

Batch = tuple[torch.Tensor, torch.Tensor]  # (images NHWC, integer labels)
Forward = Callable[..., dict]
Noise = Optional[list[torch.Tensor]]  # a train forward's dropout uniforms


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed cross entropy in fp32 (the mean is taken over exact counts)."""
    return F.cross_entropy(logits.float(), labels, reduction="sum")


def masked_forward(model: nn.Module, masks: Masks, images: torch.Tensor,
                   noise: Noise = None) -> torch.Tensor:
    """Logits of ``model`` with ``w * m`` in place of every masked weight;
    differentiable in the raw params. ``noise``: the dropout uniforms of a
    train forward (None: the model has no dropout, or evaluates)."""
    args = (images,) if noise is None else (images, noise)
    return functional_call(model, apply_masks(dict(model.named_parameters()), masks), args)


def train_forward(model: nn.Module, masks: Masks, images: torch.Tensor,
                  labels: torch.Tensor, noise: Noise = None) -> dict:
    """A train step's model work: ``loss`` (the batch mean, to take the
    backward of), the ``logits`` and the metric sums. The count is a fill
    on the device, not a copy from the host."""
    logits = masked_forward(model, masks, images, noise)
    loss_sum = cross_entropy_sum(logits, labels)
    n = labels.shape[0]
    return {
        "loss": loss_sum / n,
        "logits": logits.detach(),
        "loss_sum": loss_sum.detach(),
        "correct": (logits.detach().argmax(dim=-1) == labels).sum().float(),
        "count": torch.full((), float(n), device=labels.device),
    }


def eval_forward(model: nn.Module, masks: Masks, images: torch.Tensor,
                 labels: torch.Tensor) -> dict:
    """Metric sums over one eval batch. Rows with label < 0 are padding
    (the loaders pad the last batch with label -1) and count nowhere."""
    logits = masked_forward(model, masks, images)
    valid = labels >= 0
    safe = labels.clamp_min(0)
    per_row = F.cross_entropy(logits.float(), safe, reduction="none")
    hit = logits.argmax(dim=-1) == safe
    return {
        "loss_sum": torch.where(valid, per_row, 0.0).sum(),
        "correct": (valid & hit).sum().float(),
        "count": valid.sum().float(),
    }


def compile_forward(fn: Forward, device: torch.device) -> Forward:
    """``fn`` (``train_forward`` or ``eval_forward``) under
    ``torch.compile(fullgraph=True, dynamic=False)``; a graph break or a
    failed compile raises, it never runs eagerly instead.

    The backend follows ``device``: on CUDA, inductor with CUDA graphs
    (``mode="reduce-overhead"``), each call opening a new CUDA-graph step
    (``cudagraph_mark_step_begin``), which ends the life of the previous
    call's outputs: read or copy them before the next call. On a CPU
    device, which only the tests ask for, ``backend="aot_eager"``: dynamo's
    and AOTAutograd's tracing, with ``fullgraph``, without inductor's C++
    build.

    Each graph reads the parameters and the BatchNorm statistics from their
    storage (static inputs, see ``mark_buffers_static``) and takes the masks
    and the batch as inputs, so a level's new masks and the weights a
    rewind copies in place reach it without a recompile."""
    if device.type == "cuda":
        compiled = torch.compile(fn, fullgraph=True, dynamic=False, mode="reduce-overhead")

        def run(*args):
            torch.compiler.cudagraph_mark_step_begin()
            return compiled(*args)

        return run
    if device.type == "cpu":
        return torch.compile(fn, fullgraph=True, dynamic=False, backend="aot_eager")
    raise ValueError(f"compile_forward: no compiled step for device {device}")


def mark_buffers_static(model: nn.Module) -> None:
    """Mark ``model``'s buffers (the BatchNorm running statistics, which
    the train graph updates in place) as static inputs: CUDA graphs replay
    the update into their storage. Without it inductor would skip CUDA
    graphs for the mutated inputs. Buffers must then keep their storage:
    restores copy into them (``load_state_dict``), never rebind them."""
    for buf in model.buffers():
        torch._dynamo.mark_static_address(buf, guard=False)


class DropoutNoise:
    """A train step's dropout uniforms from one generator on ``device``,
    reseeded each step from (``seed``, step) by a hash: reproducible, and
    independent of anything else drawn."""

    def __init__(self, device: torch.device, seed: int):
        self.generator = torch.Generator(device=device)
        self.seed = seed

    def step_seed(self, step: int) -> int:
        digest = hashlib.sha256(repr((self.seed, step, "dropout")).encode()).digest()
        return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)

    def __call__(self, model: nn.Module, n: int, step: int,
                 mesh: Optional[Mesh] = None) -> Noise:
        """The uniforms of ``model``'s train forward of ``n`` images at
        ``step``; None (and nothing drawn) for a model without dropout.
        With a data axis of W ranks, ``n`` is the rank's rows: the noise of
        the global batch of ``n * W`` images is drawn and the rank's rows of
        it returned."""
        if not dropout_shapes(model, n):
            return None
        self.generator.manual_seed(self.step_seed(step))
        if mesh is None or mesh.data_size == 1:
            return draw_dropout_noise(model, n, self.generator)
        r = mesh.data_rank
        noise = draw_dropout_noise(model, n * mesh.data_size, self.generator)
        return [u[r * n:(r + 1) * n] for u in noise]


def make_train_step(
    schedule: Callable[[int], float],
    forward: Forward = train_forward,
    dropout_noise: Optional[DropoutNoise] = None,
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, Batch], dict]:
    """The train step: updates ``state`` in place (params, optimizer, step)
    and returns the metric sums. ``schedule`` sets the lr from the step;
    ``forward`` is ``train_forward`` or its compiled version;
    ``dropout_noise`` draws the step's dropout uniforms (a model with
    dropout refuses to train without them); ``mesh``: the data axis the
    gradients are averaged over (None: one process)."""
    data_parallel = mesh is not None and mesh.data_size > 1

    def train_step(state: TrainState, batch: Batch) -> dict:
        images, labels = batch
        set_lr(state.optimizer, schedule(state.step), schedule)
        state.model.train()
        # Before the forward: a compiled step's previous gradients live in
        # its CUDA-graph memory, which the next replay reuses.
        state.optimizer.zero_grad(set_to_none=True)
        noise = None
        if dropout_noise is not None:
            noise = dropout_noise(state.model, images.shape[0], state.step, mesh)
        out = forward(state.model, state.masks, images, labels, noise)
        del out["logits"]
        out.pop("loss").backward()
        if data_parallel:
            average_gradients(state.model.parameters(), mesh)
        state.optimizer.step()
        state.step += 1
        return out

    return train_step


@torch.no_grad()
def eval_step(model: nn.Module, masks: Masks, batch: Batch,
              forward: Forward = eval_forward) -> dict:
    """``forward`` (``eval_forward`` or its compiled version) on one eval
    batch, in eval mode (the running statistics) without autograd."""
    images, labels = batch
    model.eval()
    return forward(model, masks, images, labels)


def add_sums(total: Optional[dict], sums: dict) -> dict:
    """``total + sums`` into new tensors: a compiled step's outputs belong
    to its CUDA graph and are overwritten by its next replay."""
    if total is None:
        return {k: v.clone() for k, v in sums.items()}
    return {k: total[k] + sums[k] for k in total}
