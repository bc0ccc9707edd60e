"""The port's one rule for where an entry point runs: on the GPU unless
the caller names a device (``"cpu"`` for the CPU)."""
from __future__ import annotations

import torch


def resolve(device, who: str) -> torch.device:
    """``device``, or ``cuda`` when it is None; ``who`` (the entry point)
    raises when there is no GPU to default to."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who} runs on the GPU and none is "
                               f"available; pass device=\"cpu\" to run on "
                               f"the CPU")
        device = "cuda"
    return torch.device(device)
