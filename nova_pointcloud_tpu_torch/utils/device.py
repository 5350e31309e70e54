"""Device resolution for the port's entry points.

The counterpart of ``nova_pointcloud_tpu/utils/platform.py``'s role: decide
where the program runs. The port runs on ``cuda`` by default; the CPU is used
only when the caller asks for it (the tests do). Without CUDA and without an
explicit CPU request, entry points raise instead of carrying on quietly on
the CPU.
"""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> cpu; anything CUDA needs a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
