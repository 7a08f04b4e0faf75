"""N:M projection — snap unstructured masks to separable N:M patterns (port
of ``turboprune_tpu/sparse/nm.py``).

Channel compaction (compact.py) only pays when whole channels die; this
module converts the scattered masks that magnitude or ER pruning produce
into N:M block patterns that the gathered execution path (nm_execute.py)
runs at reduced width.

A layer's kernel is viewed as a 2-D matrix W[I, O] (I = contraction
width). The projected pattern is ``keep_in ⊗ keep_out``: ``keep_in`` keeps
exactly N of every M consecutive rows and (transposable variant only)
``keep_out`` exactly N of every M consecutive columns, so the backward
``dx = dy @ Wᵀ`` contraction is reduced like the forward. Because the
pattern is shared across the non-contracted axis, one index map gathers
the kept weights into dense ``[.., K·N/M]`` tensors.

Projection is monotone (``new_mask = old_mask ∧ pattern``): pruned weights
never come back, so the IMP ladder's invariant (scores at pruned positions
are exactly 0) holds.

Solvers, batched over blocks: the greedy per-block top-N of row magnitude
sums (exact for one axis), and the transposable alternating maximisation,
each half-step an exact per-block top-N given the other axis. Ties go to
the lower index (a stable descending sort, as ``lax.top_k`` breaks them),
and the sums are fp32, as the JAX package's.

Masks are the port's (torch layout, keyed by flax path): a Linear weight
``[O, I]`` and a 1x1 conv weight ``[O, C, 1, 1]`` have the matrix view
``W[I, O] = weight.reshape(O, I).T``; the port's attention projections are
Linear weights whose views are the JAX kernels' ``(D, H·hd)`` and
``(H·hd, D)``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from ..ops.masking import Masks, flax_order, state_key


class NMError(ValueError):
    """A layer's geometry cannot take the requested N:M pattern."""


# ---------------------------------------------------------------- geometry


def split_index(shape: tuple) -> Optional[int]:
    """Where the contraction axes of a torch-layout kernel start: the
    matrix view is ``(I, O) = (prod(shape[s:]), prod(shape[:s]))``. None =
    no matmul view.

    - Linear weights [O, I] (dense layers, attention projections): s=1.
    - 1x1 conv weights [O, C, 1, 1]: contraction C, s=1.
    - Anything else (spatial convs) has no matmul view.
    """
    if len(shape) == 2 or (len(shape) == 4 and shape[2] == 1 and shape[3] == 1):
        return 1
    return None


def _matrix_view(shape: tuple, s: int) -> tuple[int, int]:
    o = 1
    for d in shape[:s]:
        o *= int(d)
    i = 1
    for d in shape[s:]:
        i *= int(d)
    return i, o


def matrix(t: torch.Tensor) -> torch.Tensor:
    """The [I, O] view of a torch-layout kernel (or its mask)."""
    return t.reshape(t.shape[0], -1).T


def eligible_layers(masks: Masks) -> list[tuple[str, tuple, int]]:
    """[(path, shape, split)] for every mask with a matmul view, in the JAX
    mask tree's order."""
    out = []
    for name, m in flax_order(masks):
        s = split_index(tuple(m.shape))
        if s is not None:
            out.append((name, tuple(m.shape), s))
    return out


def check_divisibility(masks: Masks, m_block: int) -> None:
    """Fail fast (harness construction) when an eligible layer's
    contraction width does not divide into M-blocks. Output widths that do
    not divide (10-class heads) are fine: the projection is input-axis-only
    there."""
    for name, shape, s in eligible_layers(masks):
        i, _ = _matrix_view(shape, s)
        if i % m_block:
            raise NMError(
                f"layer {name!r}: contraction width {i} (kernel shape "
                f"{shape}) is not divisible by M={m_block} — this layer "
                f"cannot take an N:{m_block} pattern"
            )


# ----------------------------------------------------------------- solvers


def _topn_per_block(scores: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Exact per-block top-N: a bool keep vector with exactly n True in
    every m consecutive entries; ties go to the lower index."""
    blocks = scores.reshape(-1, m)
    order = torch.sort(blocks, dim=1, descending=True, stable=True).indices[:, :n]
    keep = torch.zeros_like(blocks, dtype=torch.bool)
    keep.scatter_(1, order, True)
    return keep.reshape(-1)


def nm_pattern_inaxis(scores: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Greedy baseline: keep the N rows of each M-block with the most
    magnitude across the output axis. Returns keep_in, bool (I,)."""
    return _topn_per_block(scores.sum(dim=1), n, m)


def nm_pattern_transposable(
    scores: torch.Tensor, n: int, m: int, iters: int = 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transposable pattern by alternating maximisation, from the greedy
    both-axes start; each half-step is the exact per-block top-N given the
    other axis, so the preserved magnitude never decreases. Returns
    (keep_in (I,), keep_out (O,))."""
    keep_in = _topn_per_block(scores.sum(dim=1), n, m)
    keep_out = _topn_per_block(scores.sum(dim=0), n, m)
    for _ in range(iters):
        keep_in = _topn_per_block(scores @ keep_out.to(scores.dtype), n, m)
        keep_out = _topn_per_block(keep_in.to(scores.dtype) @ scores, n, m)
    return keep_in, keep_out


# -------------------------------------------------------------- projection


def project_masks(
    params: Mapping[str, torch.Tensor],
    masks: Masks,
    n: int,
    m: int,
    transposable: bool = True,
) -> tuple[Masks, dict]:
    """Project every eligible mask onto its best N:M pattern. ``params``
    is the model's ``state_dict``.

    Scores are |w * mask| (pruned weights score 0, so the pattern spends
    its budget on surviving magnitude). The new mask is ``old_mask ∧
    (keep_in ⊗ keep_out)``. The output axis takes a pattern only when it is
    at least two M-blocks wide and divisible by M: at o == M the pattern
    would delete whole outputs (for a head, class logits). Contraction
    widths that do not divide raise NMError.

    Returns (new_masks, report): per-layer axes and notes, and the
    preserved magnitude against the masks before projection."""
    eligible = {name: (shape, s) for name, shape, s in eligible_layers(masks)}
    layers: dict[str, dict] = {}
    mag_before = 0.0
    mag_after = 0.0
    out: Masks = {}
    for name, mask in flax_order(masks):
        if name not in eligible:
            out[name] = mask
            continue
        shape, s = eligible[name]
        i, o = _matrix_view(shape, s)
        if i % m:
            raise NMError(f"layer {name!r}: contraction width {i} not divisible by M={m}")
        w = params[state_key(name)]
        scores = matrix(w.float().abs() * mask.to(w.device, torch.float32))
        both_axes = transposable and o % m == 0 and o >= 2 * m
        if both_axes:
            keep_in, keep_out = nm_pattern_transposable(scores, n, m)
        else:
            keep_in = nm_pattern_inaxis(scores, n, m)
            keep_out = torch.ones(o, dtype=torch.bool, device=scores.device)
        pattern = keep_in[:, None] & keep_out[None, :]
        out[name] = mask & pattern.T.reshape(shape).to(mask.device)
        mag_before += float(scores.sum())
        mag_after += float(torch.where(pattern, scores, 0.0).sum())
        layers[name] = {
            "numel": int(mask.numel()),
            "axes": "both" if both_axes else "in",
            "note": (
                ""
                if both_axes or not transposable
                else f"output width {o} (M={m}): input-axis-only"
            ),
        }
    report = {
        "pattern": f"{n}:{m}",
        "transposable": transposable,
        "layers": layers,
        "preserved_magnitude_frac": mag_after / mag_before if mag_before > 0 else 1.0,
    }
    return {name: out[name] for name in masks}, report
