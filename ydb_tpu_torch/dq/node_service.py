"""DQ node service + cross-process executer: the data plane on the wire.

The port's own copy of ``ydb_tpu/dq/node_service.py``. The reference
starts query tasks on remote nodes through a node service
(TEvStartKqpTasksRequest -> per-task compute actors,
kqp_node_service.cpp:55,121) and the executer wires channels between
compute actors on different nodes; channel traffic (TEvChannelData /
Ack) then flows peer-to-peer over the interconnect
(dq_compute_actor_channels.h:15). This module is that shape over the
port's ``dq/compute.py`` and TCP ``runtime/interconnect.py``:

  * ``DqNodeService`` — an actor registered on every worker node. On
    ``StartTasks`` it re-derives the compiled stage chain from the
    shipped stage specs + source schemas (compile_stages — schemas only,
    no data) for its own device, and registers one ComputeActor per
    task, replying ``TasksStarted`` with their ActorIds.
  * ``DistExecuter`` — builds the task graph, places stages on nodes
    (scan stages stay where the data lives), starts remote tasks via the
    services, then two-phase-wires every channel: consumer ActorIds ship
    in ``WireTask`` once all registrations are back, so ChannelData
    crosses process boundaries transparently through the interconnect's
    remote transport. Credit flow (seq/ack windows) is preserved across
    the TCP hop because acks travel the same wire back.

What crosses the wire is host data only: channel payloads are numpy
arrays (``block_to_payload``), and a scan partition shipped to a remote
node travels as host arrays of the columns its stage reads, never as a
device tensor. Envelopes pickle message classes by module path, so a
worker imports this module (``python -m ydb_tpu_torch.dq.node_service``
runs ``serve_node`` from it), and the port's nodes exchange no message
with the reference's.

Failure semantics: every wait is bounded. A dead peer surfaces as
``Undelivered`` on the sender's channel data -> the ComputeActor sends
``QueryAborted`` to the collector -> ``DistExecuter.run`` raises with
the reason instead of hanging (the TEvAbortExecution contract,
dq_compute_actor.h:41).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ydb_tpu_torch import dtypes
from ydb_tpu_torch.device import resolve_device
from ydb_tpu_torch.dq.compute import (
    ComputeActor,
    ResultCollector,
    StartTask,
    WireTask,
    compile_stages,
    task_partitions,
)
from ydb_tpu_torch.dq.graph import SourceInput, StageSpec, build_tasks
from ydb_tpu_torch.dq.spilling import Spiller
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.engine.scan import ColumnSource, required_columns
from ydb_tpu_torch.runtime.actors import Actor, ActorId


@dataclasses.dataclass
class StartTasks:
    """Start these tasks on the receiving node (kqp_node_service.cpp:55).

    ``stages`` is the FULL stage list (specs are tiny); the service
    compiles the chain locally from ``source_schemas`` — table data
    never ships, only programs and schemas. ``sources`` optionally
    carries host-resident partitions for scan tasks placed remotely."""

    query_id: str
    stages: list[StageSpec]
    tasks: list  # TaskSpec
    channels: list  # ChannelSpec (full list; tasks index into it)
    source_schemas: dict[str, dtypes.Schema]
    dicts: object = None
    key_spaces: dict | None = None
    block_rows: int = 1 << 16
    sources: dict[str, list] | None = None  # source_id -> partitions
    reply_to: ActorId | None = None
    # executer's address book: node id -> (host, port). Worker-to-worker
    # channels need routes the hello handshake alone cannot teach (a
    # worker only learns the EXECUTER's reverse route) — the reference
    # solves this with the nameservice table; here the executer ships it
    peers: dict[int, tuple] | None = None


@dataclasses.dataclass
class TasksStarted:
    query_id: str
    actor_of_task: dict[int, ActorId]


@dataclasses.dataclass
class ReleaseQuery:
    """Stop + deregister a query's compute actors on this node."""

    query_id: str


@dataclasses.dataclass
class Ping:
    """Liveness probe. Sent by the executer with the collector as the
    SENDER: a dead peer turns the ping into an Undelivered notification
    delivered straight to the collector, which fails the query — so a
    worker death is detected even when no channel data is in flight
    (the NodeDisconnected subscription the reference's executer holds
    on the interconnect session)."""


class DqNodeService(Actor):
    """Per-node task host (kqp_node_service.cpp:55). Set
    ``interconnect`` after construction so shipped peer routes
    (StartTasks.peers) reach the node's transport. Tasks compile and run
    on ``device`` (CUDA unless the caller names another)."""

    def __init__(self, interconnect=None,
                 device: "str | torch.device | None" = None):
        super().__init__()
        self.device = resolve_device(device)
        # query id -> [(actor id, actor)]: the actor ref is kept so
        # ReleaseQuery can close each task's spiller — stopping the
        # actor alone strands its spilled blobs in the store
        self._queries: dict[str, list[tuple[ActorId, object]]] = {}
        self.interconnect = interconnect
        # compiled stages repeat across queries (prepared statements):
        # memoize like the executer side does
        self._compile_cache: dict = {}

    def receive(self, message, sender):
        from ydb_tpu_torch.runtime.interconnect import Undelivered

        if isinstance(message, StartTasks):
            self._start(message, sender)
        elif isinstance(message, ReleaseQuery):
            for aid, actor in self._queries.pop(message.query_id, []):
                self.system.stop(aid)
                actor.spiller.close()
        elif isinstance(message, Ping):
            pass  # liveness: delivery (vs Undelivered) is the signal
        elif isinstance(message, Undelivered):
            # a reply (TasksStarted) bounced — the executer died. The
            # worker must survive one peer's death (other queries keep
            # running); the executer's own failure handling owns cleanup
            pass
        else:
            raise TypeError(message)

    def _start(self, req: StartTasks, sender):
        if req.peers and self.interconnect is not None:
            for node, addr in req.peers.items():
                if node != self.system.node:
                    self.interconnect.add_peer(node, addr[0], addr[1])
        compiled = compile_stages(req.stages, req.source_schemas,
                                  req.dicts, req.key_spaces,
                                  compile_cache=self._compile_cache,
                                  device=self.device)
        chan_by_id = {c.channel_id: c for c in req.channels}
        out: dict[int, ActorId] = {}
        mine: list[tuple[ActorId, object]] = []
        for t in req.tasks:
            srcs = task_partitions(req.sources or {}, t)
            a = ComputeActor(
                t, compiled[t.stage], {}, chan_by_id, srcs,
                result_target=None,
                spiller=Spiller(prefix=f"spill/{req.query_id}"
                                       f"/task{t.task_id}"),
                block_rows=req.block_rows,
            )
            aid = self.system.register(a)
            out[t.task_id] = aid
            mine.append((aid, a))
        self._queries[req.query_id] = mine
        self.send(req.reply_to if req.reply_to is not None else sender,
                  TasksStarted(req.query_id, out))


def _host(a):
    """A column as a host array (a tensor-held source's slice is copied
    off its device; numpy passes through)."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def ship_partitions(parts: list[ColumnSource],
                    names: tuple[str, ...] | None) -> list[ColumnSource]:
    """Partitions as they cross the wire: host arrays of ``names`` (all
    columns when None), the full schema kept so the receiving node
    compiles the same chain. Only the columns a stage reads are shipped;
    the reference ships every column, and the answers are the same."""
    out = []
    for p in parts:
        keep = p.schema.names if names is None else names
        cols = {n: _host(p.columns[n]) for n in keep}
        validity = ({n: _host(v) for n, v in p.validity.items()
                     if n in keep} if p.validity else None)
        out.append(ColumnSource(cols, p.schema, p.dicts, validity))
    return out


def _read_columns(stages: list[StageSpec], sid: str,
                  schema: dtypes.Schema) -> tuple[str, ...] | None:
    """Columns of source ``sid`` that some stage reads (None: all)."""
    names: set[str] = set()
    for spec in stages:
        if not any(isinstance(i, SourceInput) and i.source_id == sid
                   for i in spec.inputs):
            continue
        if spec.program is None:
            return None
        names.update(required_columns(spec.program, schema))
    return tuple(n for n in schema.names if n in names)


class DistExecuter:
    """Cross-node query executer (kqp_executer_impl.h:120 shape).

    ``services`` maps remote node id -> DqNodeService ActorId; stages
    whose placement maps to this node run in-process on ``device`` (CUDA
    unless the caller names another). The caller owns pumping the local
    system/interconnect; ``run`` drives it via the supplied ``pump``
    callable (defaults to draining the local system)."""

    def __init__(self, system, services: dict[int, ActorId] | None = None,
                 pump=None, peers: dict[int, tuple] | None = None,
                 device: "str | torch.device | None" = None):
        self.system = system
        self.services = dict(services or {})
        self._pump = pump if pump is not None else self._pump_local
        # node id -> (host, port); shipped to workers so worker-to-worker
        # channels have routes (see StartTasks.peers)
        self.peers = dict(peers or {})
        self.device = resolve_device(device)
        self._compile_cache: dict = {}
        self._seq = 0

    def _pump_local(self):
        self.system.run()
        time.sleep(0.002)

    def run(
        self,
        stages: list[StageSpec],
        sources: dict[str, list],
        placement: dict[int, int] | None = None,
        dicts=None,
        key_spaces=None,
        block_rows: int = 1 << 16,
        timeout: float = 120.0,
    ) -> OracleTable:
        """Execute a stage graph with stages placed across nodes.

        ``placement`` maps stage index -> node id (default: everything
        local). Scan stages must be placed where their partitions are
        reachable; this executer ships host-resident partitions of
        remotely-placed scan stages in StartTasks."""
        self._seq += 1
        qid = f"q{self._seq}"
        local_node = self.system.node
        placement = placement or {}
        source_schemas = {sid: parts[0].schema
                          for sid, parts in sources.items() if parts}
        compiled = compile_stages(stages, source_schemas, dicts, key_spaces,
                                  compile_cache=self._compile_cache,
                                  device=self.device)
        tasks, channels, result_stage = build_tasks(stages)
        chan_by_id = {c.channel_id: c for c in channels}

        collector = ResultCollector(compiled[result_stage].out_schema,
                                    self.device)
        collector_id = self.system.register(collector)

        # group tasks by node
        by_node: dict[int, list] = {}
        for t in tasks:
            node = placement.get(t.stage, local_node)
            by_node.setdefault(node, []).append(t)

        actor_of_task: dict[int, ActorId] = {}
        local_actors: list[ComputeActor] = []
        started: set[int] = set()
        replies: dict[int, TasksStarted] = {}
        start_error: list[str] = []

        class _Gather(Actor):
            def receive(self, message, sender):
                from ydb_tpu_torch.runtime.interconnect import Undelivered

                if isinstance(message, Undelivered):
                    # StartTasks or a start-phase ping bounced: the
                    # worker is gone before the query even started
                    start_error.append(
                        f"peer unreachable during start: {message.reason}")
                    return
                assert isinstance(message, TasksStarted)
                replies[sender.node] = message

        gather_id = self.system.register(_Gather())

        try:
            for node, node_tasks in by_node.items():
                if node == local_node:
                    for t in node_tasks:
                        srcs = task_partitions(sources, t)
                        a = ComputeActor(
                            t, compiled[t.stage], {}, chan_by_id, srcs,
                            result_target=collector_id,
                            spiller=Spiller(prefix=f"spill/{qid}"
                                                   f"/task{t.task_id}"),
                            block_rows=block_rows,
                        )
                        actor_of_task[t.task_id] = self.system.register(a)
                        local_actors.append(a)
                    continue
                svc = self.services.get(node)
                if svc is None:
                    raise ValueError(f"no DqNodeService for node {node}")
                ship = {
                    inp.source_id
                    for t in node_tasks
                    for inp in t.stage_spec.inputs
                    if isinstance(inp, SourceInput)
                }
                remote_sources = {
                    sid: ship_partitions(sources[sid], _read_columns(
                        stages, sid, source_schemas[sid]))
                    for sid in ship} or None
                # sender=gather_id: a bounce (dead worker) comes back as
                # Undelivered to the gather actor, not a silent dead letter
                self.system.send(svc, StartTasks(
                    qid, stages, node_tasks, channels, source_schemas,
                    dicts, key_spaces, block_rows, remote_sources,
                    reply_to=gather_id, peers=self.peers or None),
                    sender=gather_id)
                started.add(node)

            deadline = time.monotonic() + timeout
            remote_nodes = set(by_node) - {local_node}
            next_ping = time.monotonic() + 0.25
            while set(replies) < remote_nodes:
                if start_error:
                    raise RuntimeError(f"query aborted: {start_error[0]}")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"task start timed out; missing nodes "
                        f"{sorted(remote_nodes - set(replies))}")
                now = time.monotonic()
                if now >= next_ping:
                    # start-phase liveness: detect a worker that died
                    # while (or before) compiling its tasks
                    for node in remote_nodes - set(replies):
                        self.system.send(self.services[node], Ping(),
                                         sender=gather_id)
                    next_ping = now + 0.25
                self._pump()
            for msg in replies.values():
                actor_of_task.update(msg.actor_of_task)

            # two-phase wiring: every task learns its consumers' ActorIds
            # (local AND remote), results + aborts route to the collector
            for t in tasks:
                targets = {
                    ch: actor_of_task[chan_by_id[ch].dst_task]
                    for ch in t.output_channels
                }
                self.system.send(actor_of_task[t.task_id], WireTask(
                    targets, result_target=collector_id,
                    abort_target=collector_id))
            for t in tasks:
                self.system.send(actor_of_task[t.task_id], StartTask())

            next_ping = 0.0
            while not collector.done:
                if collector.error is not None:
                    raise RuntimeError(
                        f"query aborted: {collector.error}")
                if time.monotonic() > deadline:
                    raise TimeoutError("query timed out")
                now = time.monotonic()
                if remote_nodes and now >= next_ping:
                    # liveness: a dead peer bounces the ping back to the
                    # collector as Undelivered -> query fails fast
                    for node in remote_nodes:
                        self.system.send(self.services[node], Ping(),
                                         sender=collector_id)
                    next_ping = now + 0.25
                self._pump()
            return collector.table()
        finally:
            for node in started:
                self.system.send(self.services[node], ReleaseQuery(qid))
            for a in local_actors:
                self.system.stop(a.self_id)
                a.spiller.close()
            self.system.stop(collector_id)
            self.system.stop(gather_id)
            self._pump()


def serve_node(node: int, port_file: str,
               device: "str | torch.device | None" = None) -> None:
    """A worker node's main loop: an actor system ``node`` with a
    ``DqNodeService`` at ``ActorId(node, 1)`` behind a TCP interconnect
    on a free port, which it writes to ``port_file`` (atomically) once
    it listens; serves until the process is stopped."""
    from ydb_tpu_torch.runtime.actors import ActorSystem
    from ydb_tpu_torch.runtime.interconnect import Interconnect

    system = ActorSystem(node=node)
    ic = Interconnect(system, listen_port=0)
    svc = DqNodeService(ic, device=device)
    system.register(svc)  # ActorId(node, 1)
    with open(port_file + ".tmp", "w") as f:
        f.write(str(ic.port))
    os.replace(port_file + ".tmp", port_file)
    try:
        ic.serve()
    finally:
        ic.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ydb_tpu_torch.dq.node_service",
        description="one DQ worker node: a DqNodeService behind a TCP "
                    "interconnect")
    ap.add_argument("--node", type=int, required=True,
                    help="this node's id (its service is ActorId(node, 1))")
    ap.add_argument("--port-file", required=True,
                    help="where to write the listening port")
    ap.add_argument("--device", default=None,
                    help="device the node's tasks run on (default cuda)")
    args = ap.parse_args(argv)
    serve_node(args.node, args.port_file, args.device)
    return 0


if __name__ == "__main__":
    # run the module's own copy by its import path: envelopes pickle
    # message classes by module path, and ``__main__`` is not one the
    # executer's process can resolve
    from ydb_tpu_torch.dq.node_service import main as _main

    raise SystemExit(_main())
