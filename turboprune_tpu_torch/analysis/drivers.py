"""Shared runtime-target resolution for the port's dynamic modes.

Two modes mirror the static layer against a real run — ``--sanitize``
(thread rules vs observed locks) and ``--compile-audit`` (the executable
manifest vs the compiles dynamo actually performs). Both resolve their
target spec through one registry:

* a mode-specific table of NAMED targets (the ``pipeline``/``fleet`` load
  drivers of the sanitizer, the ``serve``/``train`` drives of the audit);
* ``path/to/file.py:builder`` — load the file, call ``builder()``;
* ``pkg.module:builder`` — import the module, call ``builder()``.

The shared train step entry (a tiny ResNet-18 on CIFAR-shaped inputs from
an explicit ``torch.Generator``, on the device passed in) also lives here.

Both modes run on ``cuda`` unless ``cpu`` is asked for, and a request for
``cuda`` without CUDA raises (``runtime_device``): nothing falls back.
torch imports stay inside functions — the analysis package imports with
no accelerator stack; only the runtime modes pay for it.
"""

from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path
from typing import Optional

__all__ = [
    "TargetError",
    "default_step_entry",
    "load_builder",
    "resolve_runtime_target",
    "runtime_device",
]


class TargetError(RuntimeError):
    """Bad target spec (CLI modes map their subclass to exit code 2)."""


def load_builder(
    spec: str, error_cls=TargetError, what: str = "target"
) -> tuple:
    """``(builder, static_paths)`` for a ``file.py:fn`` / ``pkg.module:fn``
    spec. ``static_paths`` is the file list a mode's static half should
    analyze alongside the runtime run (the defining file)."""
    mod_part, sep, fn_name = spec.rpartition(":")
    if not sep or not mod_part or not fn_name:
        raise error_cls(
            f"bad {what} {spec!r}: expected 'path/to/file.py:builder' or "
            "'pkg.module:builder'"
        )
    if mod_part.endswith(".py"):
        path = Path(mod_part)
        if not path.is_file():
            raise error_cls(f"{what}: no such file: {path}")
        mod_spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        static_paths = [path]
    else:
        try:
            mod = importlib.import_module(mod_part)
        except ImportError as e:
            raise error_cls(f"{what}: cannot import {mod_part!r}: {e}") from e
        static_paths = [Path(mod.__file__)]
    builder = getattr(mod, fn_name, None)
    if builder is None:
        raise error_cls(f"{what}: {mod_part} has no {fn_name!r}")
    return builder, static_paths


def resolve_runtime_target(
    spec: str,
    named: dict,
    error_cls=TargetError,
    what: str = "target",
    load: bool = True,
) -> tuple:
    """``("named", named[spec])`` or ``("builder", (builder, paths))``.

    ``named`` maps target names to mode-specific payloads (a driver
    callable, an entry kind — whatever the mode keys on). Anything else
    with a ``:`` resolves as a builder spec; anything else is a usage
    error that lists the names, so every mode rejects typos the same way.

    ``load=False`` defers the import: ``("builder", spec)`` comes back
    after the grammar check only, for modes that must not execute the
    target module until their instrumented window is open.
    """
    if spec in named:
        return "named", named[spec]
    if ":" in spec:
        if not load:
            return "builder", spec
        return "builder", load_builder(spec, error_cls=error_cls, what=what)
    raise error_cls(
        f"unknown {what} {spec!r}; expected one of "
        f"{', '.join(sorted(named))}, 'path/to/file.py:builder' or "
        "'pkg.module:builder'"
    )


def runtime_device(device: str, error_cls=TargetError):
    """The torch device a runtime mode runs on: ``cuda`` (the default) or
    ``cpu``. Without CUDA, ``cuda`` raises ``error_cls``."""
    from ..utils.device import resolve_device

    try:
        return resolve_device(device)
    except (RuntimeError, ValueError) as e:
        raise error_cls(str(e)) from e


def default_step_entry(device) -> tuple:
    """``(model, masks, batch, step)`` for the shared train step: a tiny
    ResNet-18 (CIFAR stem, 10 classes) initialised from an explicit
    generator, its all-ones masks, a batch of two 8x8 images and an SGD
    ``step(compiled_forward)`` that runs one masked train step through
    ``compiled_forward`` (``train.compile_forward(train_forward, device)``)
    and returns its metric sums."""
    import torch

    from ..models import create_model
    from ..ops.masking import make_masks

    gen = torch.Generator().manual_seed(0)
    model = create_model("resnet18", num_classes=10, dataset_name="CIFAR10")
    model.init_weights(gen)
    model = model.to(device)
    masks = {p: m.to(device) for p, m in make_masks(model).items()}
    images = torch.randn(2, 8, 8, 3, generator=gen).to(device)
    labels = torch.randint(0, 10, (2,), generator=gen).to(device)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)

    def step(forward):
        opt.zero_grad(set_to_none=True)
        out = forward(model, masks, images, labels)
        out["loss"].backward()
        opt.step()
        return {k: v.detach().clone() for k, v in out.items() if k != "loss"}

    return model, masks, (images, labels), step
