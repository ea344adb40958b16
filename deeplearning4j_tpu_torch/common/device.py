"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default. Asking for the card where
there is none raises; nothing quietly runs on the CPU. Tests and CPU users
pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names an absent card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def to_device(a, device: torch.device) -> torch.Tensor:
    """``a`` (a numpy array, a tensor or a scalar) as a tensor on
    ``device``. A host array bound for the card is staged in pinned memory
    and copied without blocking the host: a copy from pageable memory waits
    for every kernel queued before it, which would end the async fit loop's
    lead over the device. A tensor already there is returned as it is."""
    t = torch.as_tensor(a)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
