"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. A request for
CUDA on a machine without it raises: nothing carries on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but CUDA is not available — pass "
                "device='cpu' to run the plain PyTorch path on the CPU"
            )
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
