"""Device selection for the port's entry points.

Every entry point takes an explicit ``device``.  ``None`` means the CUDA
card: the port runs on the GPU unless the caller asks for the CPU (as the
tests do), and it never falls back to the CPU on its own.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> ``cuda`` (raising when no card is present); anything
    else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


def on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, or every one on the
    ``meta`` device (a kernel wrapper then runs its plain version: on
    ``meta`` it computes shapes only, as the dry-run does), False when
    all lie on CUDA devices; tensors on mixed devices raise."""
    devs = {t.device.type for t in ts}
    if devs in ({"cpu"}, {"meta"}):
        return True
    if devs != {"cuda"}:
        raise ValueError(f"tensors on mixed devices: {sorted(devs)}")
    return False


def indexed(device: str | torch.device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card
    (``cuda:0`` unless the caller switched), so two names of one card
    compare equal; every other device is taken as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """This rank's device in a process group that ``torchrun`` started:
    ``cuda:(LOCAL_RANK % device_count)`` (raising when no card is
    present; ``training.elastic.init_process_group`` refuses more ranks
    than cards), or ``device`` as given when it names another device or a
    card by index."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the host")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())
