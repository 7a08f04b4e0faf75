"""Density ladders and cyclic epoch schedules (host-side math).

Port of ``generate_densities`` and ``generate_cyclical_schedule`` from
``turboprune_tpu/pruning/densities.py`` (the config validation needs the
second to check ``rewind_epoch`` against level 0's first-cycle budget). The
per-layer ERK and balanced allocations come with the other criteria
(ROADMAP.md queue A, item 9).
"""

from __future__ import annotations

# "nm" is magnitude IMP + N:M projection: same geometric ladder as "mag".
ITERATIVE_METHODS = ("mag", "random_erk", "random_balanced", "nm")
PAI_METHODS = ("er_erk", "er_balanced", "synflow", "snip")


def generate_densities(
    prune_method: str,
    target_sparsity: float,
    prune_rate: float,
    current_sparsity: float = 0.0,
) -> list[float]:
    """Geometric density ladder d_{i+1} = d_i * (1 - prune_rate) down to the
    target for iterative methods; single step for PaI; [1.0] for dense."""
    if prune_method in ITERATIVE_METHODS:
        densities = []
        current_density = 1.0 - current_sparsity
        target_density = 1.0 - target_sparsity
        # Epsilon guards float dust: 0.8 * 0.8 = 0.6400000000000001 must not
        # spawn a spurious extra level past an exact target of 0.64.
        while current_density > target_density * (1.0 + 1e-9):
            densities.append(current_density)
            current_density *= 1.0 - prune_rate
        densities.append(current_density)
        return densities
    if prune_method in PAI_METHODS:
        return [1.0 - target_sparsity]
    if prune_method == "just dont":
        return [1.0]
    raise ValueError(f"Unknown pruning method: {prune_method}")


def generate_cyclical_schedule(
    epochs_per_level: int, num_cycles: int, strategy: str = "constant"
) -> list[int]:
    """Split an epoch budget across training cycles by strategy, then trim so
    the total never exceeds the budget."""
    if num_cycles <= 1:
        return [epochs_per_level]

    if strategy == "linear_decrease":
        step = epochs_per_level / (num_cycles * (num_cycles + 1) / 2)
        epochs = [int(step * (num_cycles - i)) for i in range(num_cycles)]
    elif strategy == "linear_increase":
        step = epochs_per_level / (num_cycles * (num_cycles + 1) / 2)
        epochs = [int(step * (i + 1)) for i in range(num_cycles)]
    elif strategy == "exponential_decrease":
        factor = 0.5 ** (1 / (num_cycles - 1))
        total = sum(factor**i for i in range(num_cycles))
        epochs = [int(epochs_per_level * factor**i / total) for i in range(num_cycles)]
    elif strategy == "exponential_increase":
        factor = 2 ** (1 / (num_cycles - 1))
        total = sum(factor**i for i in range(num_cycles))
        epochs = [int(epochs_per_level * factor**i / total) for i in range(num_cycles)]
    elif strategy == "cyclic_peak":
        mid = num_cycles // 2
        inc = epochs_per_level / (mid * (mid + 1) / 2)
        dec = epochs_per_level / ((num_cycles - mid) * (num_cycles - mid + 1) / 2)
        epochs = [int(inc * (i + 1)) for i in range(mid)]
        epochs += [int(dec * (num_cycles - i)) for i in range(mid, num_cycles)]
    elif strategy == "alternating":
        high = epochs_per_level // (num_cycles // 2 + num_cycles % 2)
        low = epochs_per_level // (2 * (num_cycles // 2 + num_cycles % 2))
        epochs = [high if i % 2 == 0 else low for i in range(num_cycles)]
    elif strategy == "plateau":
        inc_cycles = num_cycles // 2
        plateau_cycles = num_cycles - inc_cycles
        inc = epochs_per_level / (inc_cycles * (inc_cycles + 1) / 2)
        epochs = [int(inc * (i + 1)) for i in range(inc_cycles)]
        epochs += [epochs_per_level // num_cycles] * plateau_cycles
    elif strategy == "constant":
        epochs = [epochs_per_level // num_cycles] * num_cycles
    else:
        raise ValueError(f"Unknown cyclic strategy: {strategy}")

    total = sum(epochs)
    if total > epochs_per_level:
        # Floor-rescale; sum(floor(e*scale)) <= budget always holds after
        # this, so no further correction is needed.
        scale = epochs_per_level / total
        epochs = [int(e * scale) for e in epochs]

    # Int truncation can produce 0-epoch cycles (e.g. exponential_decrease
    # with a small budget) — the harness would silently run no-op cycles.
    # Every cycle trains at least 1 epoch; overflow is trimmed from the
    # largest cycles, which terminates because budget >= num_cycles.
    if epochs_per_level < num_cycles:
        raise ValueError(
            f"epochs_per_level={epochs_per_level} < num_cycles={num_cycles}: "
            "cannot give every cycle at least one epoch"
        )
    epochs = [max(1, e) for e in epochs]
    while sum(epochs) > epochs_per_level:
        epochs[epochs.index(max(epochs))] -= 1
    return epochs
