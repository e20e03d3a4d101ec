# ydb-devmem: device-module — the mesh's collectives: every body runs
# inside a mesh step (the step's working set, not resident buffers)
"""The shard mesh and its collectives: the port's communication substrate.

The counterpart of ``ydb_tpu/parallel/mesh.py``. The reference's
cross-node transport is Interconnect (SURVEY.md §2.2): TCP sessions +
virtual channels between every node pair. The build splits that into
two planes (SURVEY.md §5.8): bulk data rides collectives over the mesh
(this module + ``parallel/dist.py`` and ``parallel/shuffle.py``);
control traffic stays on the host actor shim (``ydb_tpu_torch.runtime``).

Mesh axes used by the engine:
  * ``shard`` — table-partition parallelism (the DP axis): each shard
    owns a horizontal slice; scans/aggregations fan out here, partial
    states merge with psum/pmin/pmax, shuffles ride all_to_all.
  * ``pipe``  — optional stage-pipelining axis for multi-stage dataflows
    (kept size 1 until the DQ stage graph spans it).

The reference runs each step as one SPMD program under ``shard_map``
over one device per shard. The port's mesh is N logical shards in one
process: shard ``i`` lives on ``devices[i % len(devices)]`` (default: the
one CUDA card, or the CPU when the caller asks for it). An SPMD step is
written as per-shard functions split at their collectives, and the
collectives are plain functions over the list of per-shard tensors:
``psum``, ``pmin``, ``pmax``, ``all_gather`` and ``all_to_all``. On one
device a collective computes its result once and every shard holds that
one tensor (an all_to_all hands each shard a view of one stacked
exchange); across devices of one process the results are peer copies.
Nothing here calls ``torch.distributed``: a backend for cards in several
processes replaces these few functions alone (ROADMAP.md queue A item
13c).
"""

from __future__ import annotations

import dataclasses

import torch

from ydb_tpu_torch.device import resolve_device

SHARD_AXIS = "shard"
PIPE_AXIS = "pipe"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_shards`` x ``n_pipe`` logical positions over ``devices``
    (round robin)."""

    n_shards: int
    n_pipe: int
    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict:
        return {SHARD_AXIS: self.n_shards, PIPE_AXIS: self.n_pipe}

    def device_of(self, shard: int, pipe: int = 0) -> torch.device:
        return self.devices[(shard * self.n_pipe + pipe) % len(self.devices)]

    @property
    def shard_devices(self) -> list[torch.device]:
        return [self.device_of(i) for i in range(self.n_shards)]


def make_mesh(n_shards: int | None = None, n_pipe: int = 1,
              devices=None) -> Mesh:
    """A mesh of ``n_shards`` (default: one per device) over ``devices``
    (default: the one CUDA device; the CPU only when named)."""
    devs = tuple(resolve_device(d) for d in devices) if devices is not None \
        else (resolve_device(None),)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if n_shards is None:
        n_shards = max(1, len(devs) // n_pipe)
    if n_shards < 1 or n_pipe < 1:
        raise ValueError(f"mesh {n_shards}x{n_pipe} is empty")
    return Mesh(int(n_shards), int(n_pipe), devs)


def shard_axis(mesh: Mesh) -> str:
    return SHARD_AXIS


# ---- collectives over the shard axis (one tensor per shard in, one
# per shard out, each on its shard's device) ----


def _replicated(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """``x`` on every shard's device: one tensor per device, shared by
    that device's shards."""
    per_dev: dict = {x.device: x}
    out = []
    for d in mesh.shard_devices:
        if d not in per_dev:
            per_dev[d] = x.to(d, non_blocking=True)
        out.append(per_dev[d])
    return out


def _reduce(mesh: Mesh, xs: list[torch.Tensor], op) -> list[torch.Tensor]:
    if len(xs) != mesh.n_shards:
        raise ValueError(f"{len(xs)} tensors for {mesh.n_shards} shards")
    root = xs[0].device
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, x.to(root, non_blocking=True))
    return _replicated(mesh, acc)


def psum(mesh: Mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Elementwise sum over the shards (integers wrap, as the
    reference's psum does)."""
    return _reduce(mesh, xs, torch.add)


def pmin(mesh: Mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    return _reduce(mesh, xs, torch.minimum)


def pmax(mesh: Mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Elementwise max over the shards (on bool: any)."""
    return _reduce(mesh, xs, lambda a, b: (a | b) if a.dtype == torch.bool
                   else torch.maximum(a, b))


def all_gather(mesh: Mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every shard gets ``stack(xs)``: shape ``(n_shards, *x.shape)``."""
    if len(xs) != mesh.n_shards:
        raise ValueError(f"{len(xs)} tensors for {mesh.n_shards} shards")
    root = xs[0].device
    return _replicated(mesh, torch.stack(
        [x.to(root, non_blocking=True) for x in xs]))


def all_to_all(mesh: Mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """``xs[j]`` has shape ``(n_shards, *rest)``; bucket ``i`` of shard
    ``j`` goes to shard ``i``: out[i] = stack_j(xs[j][i]), shape
    ``(n_shards, *rest)`` (the reference's untiled
    ``all_to_all(x, axis, 0, 0)``)."""
    n = mesh.n_shards
    if len(xs) != n:
        raise ValueError(f"{len(xs)} tensors for {n} shards")
    devs = mesh.shard_devices
    if all(d == devs[0] for d in devs) and \
            all(x.device == devs[0] for x in xs):
        sent = torch.stack(xs)  # (src j, dst i, ...)
        return [sent[:, i] for i in range(n)]
    return [torch.stack([xs[j][i].to(devs[i], non_blocking=True)
                         for j in range(n)]) for i in range(n)]
