"""Device choice for the port's entry points.

Every entry point (``TableBlock.from_numpy``, ``ScanExecutor``,
``entry``) takes an explicit ``device`` and defaults to CUDA. The CPU
is used only when the caller asks for it (the CPU tests do); with no GPU
and no explicit CPU the entry points raise instead of falling back.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``device`` as a ``torch.device``; raise when CUDA is asked for (the
    default) and this process has no usable GPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ydb_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False here; pass device='cpu' "
            "to run on the CPU")
    return dev
