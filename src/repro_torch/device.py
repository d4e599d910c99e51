"""Device selection for the port's entry points.

Every entry point takes an explicit ``device``.  ``None`` means the CUDA
card: the port runs on the GPU unless the caller asks for the CPU (as the
tests do), and it never falls back to the CPU on its own.
"""

from __future__ import annotations

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
