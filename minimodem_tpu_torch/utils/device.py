"""The device the port's entry points run on.

Every public constructor takes `device="cuda"` by default and touches no
card while it is built; the first use checks for the card and raises when
there is none.  There is no fallback to the CPU: a run on the CPU (the
kernels' plain versions) is asked for with device="cpu".
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def require(device) -> torch.device:
    """`device` as a torch.device, checked at first use: a CUDA device
    without a card raises RuntimeError."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is available (pass "
            f'device="cpu" to run on the CPU)')
    return dev
