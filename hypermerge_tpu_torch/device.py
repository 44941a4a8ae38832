"""Device resolution for the port's entry points.

The entries run on the GPU. `device=None` means `cuda`, and there is no
silent CPU fallback: without a GPU the caller must ask for the CPU
(`device="cpu"`), which runs the plain PyTorch version of each kernel.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """The torch.device an entry runs on; raises when CUDA is asked for
    (explicitly or by default) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions of the kernels"
            )
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
