"""Device resolution shared by every entry point of the port.

Entry points run on the card (`"cuda"`) unless the caller asks for the host
(`device="cpu"`, as the CPU tests do).  A CUDA device requested on a machine
without one is an error that names the device -- never a silent fall back to
the CPU.
"""

from __future__ import annotations

import torch

DEVICE_TYPES = ("cuda", "cpu")


def resolve_device(device) -> torch.device:
    """`device` (str or torch.device) as a checked `torch.device`."""
    dev = torch.device(device)
    if dev.type not in DEVICE_TYPES:
        raise ValueError(f"device must be a cuda or cpu device, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the host")
    return dev


def cli_device(device, prog: str) -> str:
    """`resolve_device` for a command-line driver: a device that is not
    there ends the program (exit code 1, the reason on stderr), with no
    fall back to the CPU."""
    try:
        return str(resolve_device(device))
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"{prog}: {e}") from None
