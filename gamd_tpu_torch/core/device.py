"""Device choice for the port's entry points (CUDA unless asked
otherwise), and the card line that every measurement prints beside its
numbers."""

import subprocess

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent.

    There is no silent move to the CPU: a caller that wants the plain
    PyTorch versions on the CPU passes device="cpu".
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was asked for but torch finds no CUDA "
            "device; pass device='cpu' to run the plain versions")
    return dev


def card_line() -> str:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them; raises if nvidia-smi fails."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
