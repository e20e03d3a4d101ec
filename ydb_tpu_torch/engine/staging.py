"""Block staging across threads: host payloads and resident slices
become device blocks on a scan's side CUDA stream.

The reference builds the blocks of a scan on a conveyor producer thread
(``TableBlock.from_numpy``, ``ydb_tpu/engine/reader.py:574-585``), and
XLA orders every device put before its readers. In torch a tensor made
on one stream and read on another needs an explicit fence, and a copy
overlaps compute only from pinned host memory on a stream of its own.
So each scan gets one ``Stager``:

  * its blocks are built on one side stream (never the consumer's);
  * host payloads go through two pinned host slabs used in turn (double
    buffering): a slab is refilled only after the event of the copy that
    last read it has fired, so the producer waits for its own copy two
    blocks back, never for the device;
  * every block carries the event recorded on the side stream after its
    last copy or kernel; ``accept`` (on the consumer's thread) makes the
    consumer's stream wait on it and records that stream on every tensor
    of the block, so the caching allocator never hands the block's memory
    to the side stream while a consumer kernel still reads it;
  * the CUDA work of a producer thread runs under ``device.capture_lock``,
    which a CUDA graph capture holds (``ssa/plan_fuse.py``).

On the CPU a ``Stager`` is ``TableBlock.from_numpy`` and ``accept`` a
no-op.

Memory sanitizer: a CUDA block built here is charged to ``staging`` as
``TableBlock.from_numpy`` charges its own, and each pinned slab to a
component of its own, ``slabs`` (host bytes, pinned for the copy engine;
released when a larger slab replaces it). A block assembled from
resident columns allocates under a seam without a charge: its columns
are the resident tier's, charged at promotion, or slices of them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.analysis import memsan
from ydb_tpu_torch.blocks.block import Column, TableBlock
from ydb_tpu_torch.device import capture_lock, resolve_device

#: byte alignment of each column inside a pinned slab (a view as any
#: dtype needs its offset to be a multiple of the item size)
_ALIGN = 64


@dataclasses.dataclass
class StagedBlock(TableBlock):
    """A block built on a side stream: ``ready`` fires when its data is
    on the device. Consumers never see one: ``accept`` turns it into a
    plain ``TableBlock``."""

    ready: "torch.cuda.Event | None" = None


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dt)).dtype


def accept(blk: TableBlock) -> TableBlock:
    """Hand a staged block to the calling thread's current stream: wait
    for its event on the device (the host does not wait) and record the
    stream on each tensor. Plain blocks pass through."""
    if not isinstance(blk, StagedBlock):
        return blk
    cur = torch.cuda.current_stream(blk.device)
    if blk.ready is not None:
        cur.wait_event(blk.ready)
    for c in blk.columns.values():
        c.data.record_stream(cur)
        c.validity.record_stream(cur)
    blk.length.record_stream(cur)
    return TableBlock(blk.columns, blk.length, blk.schema)


class Stager:
    """One scan's block builder (see the module docstring)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self._stream = None
        self._slabs: list = [None, None]
        self._slab_tickets: list = [None, None]
        self._events: list = [None, None]
        self._turn = 0

    def _side(self) -> "torch.cuda.Stream":
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _slab(self, nbytes: int) -> np.ndarray:
        """The next pinned slab, at least ``nbytes`` long, once the copy
        that last read it has finished."""
        i = self._turn
        self._turn ^= 1
        ev = self._events[i]
        if ev is not None:
            ev.synchronize()
        slab = self._slabs[i]
        if slab is None or slab.numel() < nbytes:
            slab = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                               pin_memory=True)
            self._slabs[i] = slab
            if memsan.armed():
                memsan.release(self._slab_tickets[i])
                self._slab_tickets[i] = memsan.charge(
                    slab.numel(), "slabs", owner="stager")
        self._cur = i
        return slab

    def from_numpy(self, cols: dict, valid: dict, sch: dtypes.Schema,
                   cap: int) -> TableBlock:
        """A block of ``cap`` rows from host (cols, valid) payloads."""
        if not self.cuda:
            # a CPU block shares its arrays; zero-copy decoded chunks are
            # read-only views into blob bytes, so those get a copy
            def own(d):
                return {k: (a if a.flags.writeable else np.array(a))
                        for k, a in (d or {}).items()}

            return TableBlock.from_numpy(own(cols), sch, own(valid),
                                         capacity=cap, device=self.device)
        names = sch.names
        n = len(cols[names[0]]) if names else 0
        arrays = {}
        need = 0
        for m in names:
            a = np.ascontiguousarray(cols[m],
                                     dtype=sch.field(m).type.physical)
            v = valid.get(m) if valid else None
            v = None if v is None else np.ascontiguousarray(v,
                                                            dtype=np.bool_)
            arrays[m] = (a, v)
            need += -(-a.nbytes // _ALIGN) * _ALIGN
            if v is not None:
                need += -(-v.nbytes // _ALIGN) * _ALIGN
        with capture_lock, memsan.seam():
            slab = self._slab(need)
            host = slab.numpy()
            s = self._side()
            out = {}
            off = 0

            def put(arr: np.ndarray, tdt: torch.dtype) -> torch.Tensor:
                nonlocal off
                nb = arr.nbytes
                np.copyto(host[off:off + nb].view(arr.dtype), arr)
                src = slab[off:off + nb].view(_torch_dtype(arr.dtype))
                off += -(-nb // _ALIGN) * _ALIGN
                d = torch.empty(cap, dtype=tdt, device=self.device)
                d[:n].copy_(src, non_blocking=True)
                if cap > n:
                    d[n:].zero_()
                return d

            with torch.cuda.stream(s):
                for m in names:
                    a, v = arrays[m]
                    data = put(a, dtypes.torch_dtype(sch.field(m).type))
                    if v is None:
                        vt = torch.zeros(cap, dtype=torch.bool,
                                         device=self.device)
                        vt[:n] = True
                    else:
                        vt = put(v, torch.bool)
                    out[m] = Column(data, vt)
                length = torch.full((), n, dtype=torch.int32,
                                    device=self.device)
                ev = torch.cuda.Event()
                ev.record(s)
            self._events[self._cur] = ev
        blk = StagedBlock(out, length, sch, ready=ev)
        if memsan.armed():
            memsan.charge(memsan.nbytes_of(blk), "staging",
                          owner="stager")
        return blk

    def assemble(self, build) -> TableBlock:
        """Run ``build(side_stream_or_None)`` — device slicing and
        concatenation of resident columns — on the side stream, and fence
        the block it returns. ``build`` records the side stream on the
        tensors it reads (``reading``)."""
        if not self.cuda:
            with memsan.seam():
                return build(None)
        with capture_lock, memsan.seam():
            s = self._side()
            with torch.cuda.stream(s):
                blk = build(s)
                ev = torch.cuda.Event()
                ev.record(s)
        return StagedBlock(blk.columns, blk.length, blk.schema, ready=ev)


def reading(t: torch.Tensor, stream) -> torch.Tensor:
    """Mark ``t`` (a resident tensor made on another stream) as read by
    ``stream``: its memory is not reused before that work is done."""
    if stream is not None:
        t.record_stream(stream)
    return t
