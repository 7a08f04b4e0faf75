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
SGD or AdamW), ``set_lr`` (a Python float that must not become a graph
constant) and the step counter.

Metrics are SUMS (``loss_sum``, ``correct``, ``count``) kept on the device;
the harness adds them up over an epoch (``add_sums``, into tensors no graph
owns) and reads them once at its end.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..ops.masking import Masks, apply_masks
from .optim import set_lr
from .state import TrainState

Batch = tuple[torch.Tensor, torch.Tensor]  # (images NHWC, integer labels)
Forward = Callable[[nn.Module, Masks, torch.Tensor, torch.Tensor], dict]


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed cross entropy in fp32 (the mean is taken over exact counts)."""
    return F.cross_entropy(logits.float(), labels, reduction="sum")


def masked_forward(model: nn.Module, masks: Masks, images: torch.Tensor) -> torch.Tensor:
    """Logits of ``model`` with ``w * m`` in place of every masked weight;
    differentiable in the raw params."""
    return functional_call(model, apply_masks(dict(model.named_parameters()), masks), (images,))


def train_forward(model: nn.Module, masks: Masks, images: torch.Tensor,
                  labels: torch.Tensor) -> dict:
    """A train step's model work: ``loss`` (the batch mean, to take the
    backward of), the ``logits`` and the metric sums. The count is a fill
    on the device, not a copy from the host."""
    logits = masked_forward(model, masks, images)
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


def make_train_step(
    schedule: Callable[[int], float],
    forward: Forward = train_forward,
) -> Callable[[TrainState, Batch], dict]:
    """The train step: updates ``state`` in place (params, optimizer, step)
    and returns the metric sums. ``schedule`` sets the lr from the step;
    ``forward`` is ``train_forward`` or its compiled version."""

    def train_step(state: TrainState, batch: Batch) -> dict:
        images, labels = batch
        set_lr(state.optimizer, schedule(state.step))
        state.model.train()
        # Before the forward: a compiled step's previous gradients live in
        # its CUDA-graph memory, which the next replay reuses.
        state.optimizer.zero_grad(set_to_none=True)
        out = forward(state.model, state.masks, images, labels)
        del out["logits"]
        out.pop("loss").backward()
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
