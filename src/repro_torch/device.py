"""Device resolution for the port's entry points.

Entry points default to the card. Asking for ``"cuda"`` where no CUDA device
is visible raises: the port never carries on quietly on the CPU. The CPU is
used only when the caller names it (the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``, checking that it exists.

    On CUDA this also turns TF32 off for the plain products the port leaves
    to PyTorch (k-means, the cell scan): TF32 keeps about three decimal
    digits, and candidate scores must agree with the fp32 reference to 1e-5.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but no CUDA device is visible; "
                "pass device='cpu' to run the port on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
