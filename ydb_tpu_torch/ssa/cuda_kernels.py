# ydb-devmem: device-module — kernel launch wrappers: their outputs are
# the calling kernel's results (the dispatch's working set); the one
# persistent buffer, the per-device ticket slab, is bounded by
# TICKET_STREAMS rows
"""Hand-written CUDA kernels for the hot group-by reduction.

The counterpart of ``ydb_tpu/ssa/pallas_kernels.py``. Two entry points
of one kernel body in ``ydb_tpu_torch/csrc/grouped_sum.cu`` (compiled
with ``nvcc`` for ``sm_90a`` at first use, loaded with ctypes):

  * ``grouped_sum`` — per-group sum of one column (replaces
    ``pallas_kernels.grouped_sum``, reached from ``kernels.scatter_sum``
    on the per-aggregate group-by path);
  * ``grouped_sum_multi`` — per-group sums of every column of a
    (rows x slots) matrix in one pass (replaces
    ``pallas_kernels.grouped_sum_multi``, reached from
    ``kernels.fused_group_reduce`` on the fused path).

One call is one device launch. The output is allocated with
``torch.empty`` and written whole by the kernel (no zero fill). Beside
it the wrapper passes a scratch buffer, also ``torch.empty``, for the
per-cluster partial sums (``_launch_plan`` sizes both the grid and the
scratch), and ``CLUSTER`` tickets per 16-slot chunk (one per slice of
the output) from a zeroed per-device slab, one row of tickets per
stream: the CTA that counts last for a slice resets its ticket, so
launches on one stream, and replays of a captured CUDA graph, find
them at zero. A graph keeps the tickets of the stream it was captured
on: replay it on one stream at a time. The slab is allocated at the
device's first launch, which must not be inside a capture (it would
live in the graph's private pool, freed with the graph): ``_tickets``
raises there. A stream's row is a view of the slab, so a stream's first
launch may be captured.

Beside each kernel sits its plain torch version (``*_plain``). A wrapper
given a CUDA tensor launches the kernel or raises; given a CPU tensor it
runs the plain version — the CPU tests compare that arithmetic with the
JAX package, and ``chip_smoke.py`` compares each kernel with its plain
version on the card. There is no fallback from a failed build or launch.

Eligibility is the reference's (``supported``/``supported_fused``), so
the tier a program takes is the same in both packages. ``FORCE`` and
``YDB_TPU_TORCH_KERNELS`` mirror ``pallas_kernels.FORCE`` /
``YDB_TPU_PALLAS``: off sends the tier to the plain scatter instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import NamedTuple

import torch

from ydb_tpu_torch.analysis import syncsan

MAX_GROUPS = 2048
MAX_FUSED_SLOTS = 128

# launch geometry, as in csrc/grouped_sum.cu (kSlotChunk, kCluster)
SLOT_CHUNK = 16
CLUSTER = 8
#: (row, slot) elements a cluster should take before one more cluster,
#: whose partial the last CTA of each slice must also read, pays off: 16
#: a thread at the kernel's 512 threads per CTA, 8 at its 1024 (int32
#: 16-slot chunks)
ELEMS_PER_CLUSTER = 1 << 16
#: streams per device that can hold a row of tickets at once
TICKET_STREAMS = 256

#: test/bench override: True/False forces the decision regardless of the
#: environment (read when a program runs)
FORCE: bool | None = None

#: kernel launches since the last ``reset_launches()``; each wrapper adds
#: one where it launches its CUDA kernel and nowhere else. A call made
#: while a CUDA graph is being captured launches nothing: it adds one to
#: ``CAPTURED`` instead, and every replay of that graph adds the kernels
#: it holds here (``count_replay``)
LAUNCHES = {"grouped_sum": 0, "grouped_sum_multi": 0}
#: kernel launches recorded into CUDA graphs under capture (never reset:
#: a capturer reads the difference across its capture)
CAPTURED = {"grouped_sum": 0, "grouped_sum_multi": 0}

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "grouped_sum.cu"
BUILD_DIR = (pathlib.Path(__file__).resolve().parent.parent.parent
             / "build" / "ydb_tpu_torch_kernels")
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}

_lib = None
_lock = threading.Lock()
#: guards LAUNCHES and CAPTURED: statements on several threads launch
_counts_lock = threading.Lock()
#: (device index, dtype, slots capped at SLOT_CHUNK, num_groups) -> the
#: number of clusters of that launch the device holds at once
_max_clusters: dict = {}
#: device index -> int32 (TICKET_STREAMS, chunks x CLUSTER) zeroed slab, and
#: (device index, stream handle) -> its row
_ticket_slabs: dict = {}
_ticket_rows: dict = {}


def enabled() -> bool:
    if FORCE is not None:
        return FORCE
    v = os.environ.get("YDB_TPU_TORCH_KERNELS")
    if v is not None:
        return v not in ("0", "", "off")
    return True


def supported(dtype, num_groups: int) -> bool:
    return dtype in (torch.float32, torch.int32) and num_groups <= MAX_GROUPS


def supported_fused(dtype, num_groups: int, n_slots: int) -> bool:
    """Eligibility of the fused multi-column kernel
    (kernels.fused_group_reduce's >ONEHOT tier)."""
    return supported(dtype, num_groups) and n_slots <= MAX_FUSED_SLOTS


def reset_launches() -> None:
    with _counts_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    """One launch of kernel ``name`` on the current stream: counted now,
    or, under graph capture, at every replay of the graph."""
    capturing = torch.cuda.is_current_stream_capturing()
    with _counts_lock:
        if capturing:
            CAPTURED[name] += 1
        else:
            LAUNCHES[name] += 1


def count_replay(captured: dict) -> None:
    """One replay of a CUDA graph that holds ``captured`` kernel launches
    (the difference of ``CAPTURED`` across its capture): each of them
    launches again."""
    with _counts_lock:
        for k, n in captured.items():
            LAUNCHES[k] += n


# ---------------- build + bind ----------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernel source into a shared library under
    ``build/ydb_tpu_torch_kernels`` (named by the source's hash, so an
    edited source rebuilds) and return its path. A build event for the
    sync sanitizer (a cached library counts too: it is loaded once)."""
    syncsan.count(builds=1)
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libgrouped_sum_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.ydb_grouped_sum_multi.argtypes = [p, p, p, p, p, ll, i, i, i,
                                                  i, p]
            lib.ydb_grouped_sum_multi.restype = i
            lib.ydb_grouped_sum.argtypes = [p, p, p, p, p, ll, i, i, i, p]
            lib.ydb_grouped_sum.restype = i
            lib.ydb_grouped_sum_max_clusters.argtypes = [
                i, i, i, ctypes.POINTER(i)]
            lib.ydb_grouped_sum_max_clusters.restype = i
            _lib = lib
        return _lib


class LaunchPlan(NamedTuple):
    clusters: int       # thread-block clusters of CLUSTER CTAs (grid x)
    chunks: int         # SLOT_CHUNK-slot chunks (grid y)
    chunk_width: int    # slots of the widest chunk
    part_stride: int    # elements per cluster partial: groups x width, to 4
    scratch_elems: int  # per-cluster partials: chunks x clusters x part_stride


def _launch_plan(rows: int, slots: int, num_groups: int,
                 max_clusters: int) -> LaunchPlan:
    """The grid and scratch of one launch: as many clusters as give each
    about ELEMS_PER_CLUSTER (row, slot) elements, at least one and at
    most the ``max_clusters`` the device holds at once. Partials are
    padded to a multiple of 4 elements (the kernel's ``part_stride_of``)
    for 16-byte loads."""
    width = min(slots, SLOT_CHUNK)
    chunks = -(-slots // SLOT_CHUNK)
    clusters = max(1, min(max_clusters,
                          -(-rows * width // ELEMS_PER_CLUSTER)))
    part_stride = -(-num_groups * width // 4) * 4
    return LaunchPlan(clusters, chunks, width, part_stride,
                      chunks * clusters * part_stride)


def _device_max_clusters(lib, device: torch.device, dtype, slots: int,
                         num_groups: int) -> int:
    key = (device.index, dtype, min(slots, SLOT_CHUNK), num_groups)
    n = _max_clusters.get(key)
    if n is None:
        count = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.ydb_grouped_sum_max_clusters(
                min(slots, SLOT_CHUNK), num_groups, _DTYPE_CODE[dtype],
                ctypes.byref(count))
        _raise_on(err, "cudaOccupancyMaxActiveClusters for grouped_sum")
        if count.value < 1:
            raise RuntimeError(
                f"grouped_sum: no cluster of {CLUSTER} CTAs fits on {device} "
                f"({num_groups} groups, {slots} slots, {dtype})")
        n = count.value
        with _lock:
            _max_clusters[key] = n
    return n


def _tickets(device: torch.device, stream: int) -> torch.Tensor:
    """This stream's row of tickets: CLUSTER per 16-slot chunk, one per
    slice of the output (zero between launches)."""
    key = (device.index, stream)
    row = _ticket_rows.get(key)
    if row is not None:
        return row
    with _lock:
        row = _ticket_rows.get(key)
        if row is None:
            slab = _ticket_slabs.get(device.index)
            if slab is None:
                if (device.type == "cuda"
                        and torch.cuda.is_current_stream_capturing()):
                    raise RuntimeError(
                        f"grouped_sum: first launch on {device} inside a "
                        "CUDA graph capture; launch once outside capture "
                        "first, so the ticket slab lives outside the "
                        "graph's private pool")
                slab = _ticket_slabs[device.index] = torch.zeros(
                    (TICKET_STREAMS,
                     -(-MAX_FUSED_SLOTS // SLOT_CHUNK) * CLUSTER),
                    dtype=torch.int32, device=device)
            taken = sum(k[0] == device.index for k in _ticket_rows)
            if taken >= TICKET_STREAMS:
                raise RuntimeError(
                    f"grouped_sum: more than {TICKET_STREAMS} streams on "
                    f"{device} hold kernel tickets")
            row = _ticket_rows.setdefault(key, slab[taken])
    return row


def _check(values: torch.Tensor, gid: torch.Tensor, num_groups: int,
           ndim: int) -> None:
    if values.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes int32/float32 values, got {values.dtype}")
    if gid.dtype != torch.int32:
        raise TypeError(f"kernel takes int32 group ids, got {gid.dtype}")
    if values.ndim != ndim or gid.ndim != 1 or gid.shape[0] != values.shape[0]:
        raise ValueError(f"bad shapes {tuple(values.shape)} / {tuple(gid.shape)}")
    if gid.device != values.device:
        raise ValueError("values and group ids on different devices")
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"num_groups {num_groups} outside [1, {MAX_GROUPS}]")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _launch(entry: str, values: torch.Tensor, gid: torch.Tensor,
            num_groups: int) -> torch.Tensor:
    """One launch of the kernel through C entry point ``entry`` on the
    current stream; values (rows x slots) -> (num_groups x slots)."""
    lib = _library()
    values = values.contiguous()
    gid = gid.contiguous()
    rows, slots = values.shape
    dev = values.device
    plan = _launch_plan(rows, slots, num_groups, _device_max_clusters(
        lib, dev, values.dtype, slots, num_groups))
    out = torch.empty((num_groups, slots), dtype=values.dtype, device=dev)
    scratch = torch.empty(plan.scratch_elems, dtype=values.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (values.data_ptr(), gid.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), _tickets(dev, stream).data_ptr(), rows)
    if entry == "ydb_grouped_sum":
        err = lib.ydb_grouped_sum(*ptrs, num_groups, plan.clusters,
                                  _DTYPE_CODE[values.dtype], stream)
    else:
        err = lib.ydb_grouped_sum_multi(*ptrs, slots, num_groups,
                                        plan.clusters,
                                        _DTYPE_CODE[values.dtype], stream)
    _raise_on(err, entry)
    return out


# ---------------- grouped_sum_multi ----------------


def grouped_sum_multi_plain(values: torch.Tensor, gid: torch.Tensor,
                            num_groups: int) -> torch.Tensor:
    """Plain torch version: (rows x slots) -> (num_groups x slots) sums;
    ids outside [0, num_groups) go to a spare slot that is sliced off."""
    ok = (gid >= 0) & (gid < num_groups)
    idx = torch.where(ok, gid, num_groups).long()
    out = torch.zeros((num_groups + 1, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, idx, values)
    return out[:num_groups]


def grouped_sum_multi(values: torch.Tensor, gid: torch.Tensor,
                      num_groups: int) -> torch.Tensor:
    """Fused multi-column grouped sum: (rows x slots) int32/float32
    values -> (num_groups x slots). CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    _check(values, gid, num_groups, 2)
    if values.shape[1] > MAX_FUSED_SLOTS:
        raise ValueError(f"{values.shape[1]} slots > {MAX_FUSED_SLOTS}")
    if not values.is_cuda:
        return grouped_sum_multi_plain(values, gid, num_groups)
    out = _launch("ydb_grouped_sum_multi", values, gid, num_groups)
    _count("grouped_sum_multi")
    return out


# ---------------- grouped_sum ----------------


def grouped_sum_plain(values: torch.Tensor, gid: torch.Tensor,
                      num_groups: int) -> torch.Tensor:
    """Plain torch version of the one-column grouped sum."""
    return grouped_sum_multi_plain(values[:, None], gid, num_groups)[:, 0]


def grouped_sum(values: torch.Tensor, gid: torch.Tensor,
                num_groups: int) -> torch.Tensor:
    """Sum of ``values`` per group id; rows with ids outside
    [0, num_groups) drop. CUDA tensors launch the kernel, CPU tensors
    take the plain version."""
    _check(values, gid, num_groups, 1)
    if not values.is_cuda:
        return grouped_sum_plain(values, gid, num_groups)
    out = _launch("ydb_grouped_sum", values[:, None], gid, num_groups)
    _count("grouped_sum")
    return out[:, 0]


def scatter_sum_kernel(values, valid_row, gid, num_groups: int, dtype=None):
    """Drop-in twin of kernels.scatter_sum for supported dtypes (the
    reference's ``scatter_sum_pallas``)."""
    dtype = dtype or values.dtype
    idx = torch.where(valid_row, gid, num_groups).to(torch.int32)
    return grouped_sum(values.to(dtype), idx, num_groups)
