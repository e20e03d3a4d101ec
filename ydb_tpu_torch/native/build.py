"""On-demand build of the native host library.

The port's own copy of ``ydb_tpu/native/build.py``: one ``g++``
invocation at first use, into ``build/ydb_tpu_torch_native`` at the root
of the checkout (never into the package directory). The library is
named by a hash of its source and flags, so an edited source rebuilds
and a stale library is never loaded. No toolchain, or a failed compile,
leaves ``ensure_built`` returning None and ``ydb_tpu_torch.native`` on
its numpy twins (same bits, slower); ``ensure_built(strict=True)`` raises
with the compiler's output instead, for a caller that needs the library
(``chip_smoke.py``'s phase 18). ``YDB_TPU_TORCH_NO_NATIVE=1`` forces the
twins.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import tempfile

SOURCE = pathlib.Path(__file__).resolve().parent / "src" / "ydbtpu_native.cpp"
BUILD_DIR = (pathlib.Path(__file__).resolve().parent.parent.parent
             / "build" / "ydb_tpu_torch_native")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def ensure_built(strict: bool = False) -> str | None:
    """Compile if no library of this source exists yet; returns the .so
    path, or None when disabled or unbuildable (``strict`` raises)."""
    if os.environ.get("YDB_TPU_TORCH_NO_NATIVE"):
        if strict:
            raise RuntimeError("YDB_TPU_TORCH_NO_NATIVE is set")
        return None
    try:
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"libydbtpu_native_{tag}.so"
        if out.exists():
            return str(out)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # concurrent first builds (test workers, conveyor threads) each
        # write their own temporary file; the rename is atomic
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(["g++", *FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return str(out)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        if strict:
            raise
        return None
