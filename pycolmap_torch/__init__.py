"""pycolmap_torch — the PyTorch/CUDA port of pycolmap_tpu.

The package mirrors the ``pycolmap_tpu`` tree file for file, so each module
names its reference twin. Plain tensor code is PyTorch; every Pallas kernel
of the reference becomes a CUDA C++ kernel for Hopper (``*/csrc``, built by
``_cuda_build.py``), with a plain PyTorch version beside it that serves CPU
tensors.

Entry points run on the card unless the caller passes ``device="cpu"``.
Called with no device on a host without CUDA they raise: there is no silent
CPU fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card (``cuda``); a host without CUDA raises. A CUDA
    device that is not available raises as well; ``"cpu"`` always works.
    """
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pycolmap_torch runs on a CUDA device by default and this host "
            "has none; pass device='cpu' to run the plain PyTorch versions"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device
