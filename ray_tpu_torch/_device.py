"""Device selection for the port's entry points: ``cuda`` unless asked."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises when a CUDA device is asked for and
    none is present: nothing falls back to the CPU unless the caller passes
    ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on cuda by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def check_params_on(params: dict, device: torch.device) -> None:
    """Raise unless the model's parameters lie on ``device``."""
    got = params["embed"].device
    if got.type != device.type or (device.index is not None
                                   and got.index != device.index):
        raise ValueError(f"params are on {got}, the call asked for {device}")
