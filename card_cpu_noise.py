#!/usr/bin/env python3
"""How far one fp32 train step's gradients of ResNet-18 lie from float64,
by route and by order of the batch: the noise that chip_smoke.py's
card-against-CPU check of the compiled step is held to.

    python3 card_cpu_noise.py [--sets N] [--device cuda|cpu]

ResNet-18 at full width, CIFAR stem, fp32, TF32 off, batch 32 (the
check's weights, batch and seed). Mask sets: all ones, global magnitude
at density 0.8 on the initial weights, and N - 2 more on the initial
weights plus Gaussian noise of 0.3 of each tensor's std (seeds 1, 2, ...).
For each set, each tensor's gradient is taken on the CPU in fp32, on the
device eagerly and on the device compiled (``train.compile_forward``),
each with the batch in CARD_ORDERS orders (the batch and fixed
permutations), and held to the float64 gradient on the CPU.

Prints per set the check's per-tensor excess (distance from float64 less
1e-3 + 2 x the noise; above 0 fails) three ways: the compiled step against
one draw of the CPU's and the eager device's noise (the rule before
chip_smoke.py took the noise over orders), the eager device held to the
same rule in the compiled step's place, and the compiled step against
the noise over all orders (chip_smoke.py's rule). Then the whole
gradient: the compiled step's and the eager device's against the CPU's
(the rule's limit 1e-3 before chip_smoke.py held it to float64); the
compiled step's from float64 against 1e-3 + 2 x the largest distance of
the CPU's and the eager device's over the orders (chip_smoke.py's rule);
the compiled step against the eager one within twice that. And the
tensor lying farthest from float64 on the CPU with its distance in each
order. Then how many sets fail each rule. With ``--device cpu`` the compiled step is
``aot_eager``.
"""

from __future__ import annotations

import argparse
import copy
import statistics
import subprocess
import sys

import torch

from turboprune_tpu_torch.data.augment import CIFAR10_MEAN, CIFAR10_STD, normalize_uint8
from turboprune_tpu_torch.data.synthetic import synthetic_arrays
from turboprune_tpu_torch.models import create_model
from turboprune_tpu_torch.ops.masking import make_masks
from turboprune_tpu_torch.pruning.criteria import prune_mag
from turboprune_tpu_torch.train import compile_forward, mark_buffers_static, train_forward

BATCH, GRAD, CARD_ORDERS = 32, 1e-3, 4


def _dist(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _flat(g: dict) -> torch.Tensor:
    return torch.cat([v.reshape(-1) for v in g.values()])


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sets", type=int, default=15)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("card_cpu_noise: no CUDA device (pass --device cpu)")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    x, y = synthetic_arrays(BATCH, 32, 10, seed=11)
    images = normalize_uint8(torch.from_numpy(x), CIFAR10_MEAN, CIFAR10_STD)
    labels = torch.from_numpy(y).long()
    cpu = create_model("resnet18", 10, "CIFAR10").init_weights(torch.Generator().manual_seed(0))
    weights = {k: v.clone() for k, v in cpu.state_dict().items()}
    exact = copy.deepcopy(cpu).double()
    for module in exact.modules():
        if hasattr(module, "dtype"):
            module.dtype = torch.float64
    exact.fc.forward = lambda z, fc=exact.fc: torch.nn.functional.linear(
        z.double(), fc.weight, fc.bias)
    eager = copy.deepcopy(cpu).to(device)
    compiled = copy.deepcopy(cpu).to(device)
    mark_buffers_static(compiled)
    routes = {"cpu": (cpu, torch.device("cpu"), train_forward),
              "eager": (eager, device, train_forward),
              "compiled": (compiled, device, compile_forward(train_forward, device))}
    orders = [torch.arange(BATCH)] + [
        torch.randperm(BATCH, generator=torch.Generator().manual_seed(i))
        for i in range(1, CARD_ORDERS)]

    def grads(model, dev, forward, masks, order, dtype=torch.float32) -> dict:
        model.load_state_dict({k: v.to(dtype) for k, v in weights.items()})
        model.train()
        params = dict(model.named_parameters())
        res = forward(model, {p: m.to(dev) for p, m in masks.items()},
                      images[order].to(dev, dtype), labels[order].to(dev))
        g = torch.autograd.grad(res["loss"], list(params.values()))
        return {k: v.detach().cpu().double() for k, v in zip(params, g)}

    base = make_masks(cpu)
    params0 = {k: v.detach() for k, v in cpu.named_parameters()}
    sets = [("ones", base), ("magnitude 0.8", prune_mag(params0, base, 0.8))]
    for s in range(1, args.sets - 1):
        gen = torch.Generator().manual_seed(s)
        noisy = {k: v + 0.3 * v.std() * torch.randn(v.shape, generator=gen)
                 for k, v in params0.items()}
        sets.append((f"magnitude 0.8, noisy {s}", prune_mag(noisy, base, 0.8)))

    fails = {"one draw": 0, "eager in its place": 0, "over orders": 0, "whole compiled": 0,
             "whole eager": 0, "whole over orders": 0, "compiled vs eager": 0}
    for name, masks in sets:
        g64 = grads(exact, torch.device("cpu"), train_forward, masks, orders[0], torch.float64)
        g = {r: [grads(m, d, f, masks, o) for o in orders] for r, (m, d, f) in routes.items()}
        d = {r: [{k: _dist(v[k], g64[k]) for k in g64} for v in gs] for r, gs in g.items()}

        def excess(route, noise_routes, n_orders):
            ex = {k: d[route][0][k] - (GRAD + 2 * max(
                d[r][i][k] for r in noise_routes for i in range(n_orders))) for k in g64}
            worst = max(ex, key=ex.get)
            return ex[worst], worst

        rules = {"one draw": excess("compiled", ("cpu", "eager"), 1),
                 "eager in its place": excess("eager", ("cpu", "compiled"), 1),
                 "over orders": excess("compiled", ("cpu", "eager"), CARD_ORDERS)}
        whole = _dist(_flat(g["compiled"][0]), _flat(g["cpu"][0]))
        whole_eager = _dist(_flat(g["eager"][0]), _flat(g["cpu"][0]))
        flat64 = _flat(g64)
        noise = max(_dist(_flat(v), flat64) for r in ("cpu", "eager") for v in g[r])
        whole64 = _dist(_flat(g["compiled"][0]), flat64)
        pair = _dist(_flat(g["compiled"][0]), _flat(g["eager"][0]))
        limit = GRAD + 2 * noise
        spread = max(g64, key=lambda k: max(o[k] for o in d["cpu"]))
        for rule, (ex, _) in rules.items():
            fails[rule] += ex > 0
        fails["whole compiled"] += whole > GRAD
        fails["whole eager"] += whole_eager > GRAD
        fails["whole over orders"] += whole64 > limit
        fails["compiled vs eager"] += pair > 2 * limit
        print(f"{name}: " + "; ".join(f"{rule} {ex:+.3e} ({k})" for rule, (ex, k) in rules.items())
              + f"; whole compiled vs cpu {whole:.3e}, eager vs cpu {whole_eager:.3e}, "
              + f"compiled from float64 {whole64:.3e} (limit {limit:.3e}), compiled vs eager "
              + f"{pair:.3e} (limit {2 * limit:.3e}); "
              + "median distance from float64 " + ", ".join(
                  f"{r} {statistics.median(d[r][0].values()):.3e}" for r in d)
              + f"; farthest on the cpu, over the orders: {spread} "
              + ", ".join(f"{o[spread]:.1e}" for o in d["cpu"]), flush=True)
    print(f"sets failing, of {len(sets)}: {fails}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
