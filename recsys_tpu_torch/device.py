"""Which device an entry point runs on.

Every entry point of the port takes ``device="cuda"`` unless the caller asks
for another; without a CUDA device that raises here, it never gives way to
the CPU. The tests pass ``"cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(name: torch.device | str = "cuda") -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device
