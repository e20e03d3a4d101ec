"""Device choice for the port's entry points.

Every entry point (``TableBlock.from_numpy``, ``ScanExecutor``,
``entry``) takes an explicit ``device`` and defaults to CUDA. The CPU
is used only when the caller asks for it (the CPU tests do); with no GPU
and no explicit CPU the entry points raise instead of falling back.
"""

from __future__ import annotations

import threading

import torch

DEFAULT_DEVICE = "cuda"

#: Held by a CUDA graph capture (``ssa/plan_fuse.py``: warm-up and
#: capture) and by every worker thread around the CUDA work it issues
#: (block staging on a scan's producer thread, resident promotion). A
#: capture in the default mode fails when another thread calls the CUDA
#: API meanwhile, and the warm-up's ``set_sync_debug_mode("error")`` is
#: process-wide.
capture_lock = threading.RLock()


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


def same_device(a, b) -> bool:
    """Whether two device specs name one device (``cuda`` is the current
    CUDA device)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or (a.index is not None and b.index is not None):
        return a.index == b.index
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)
