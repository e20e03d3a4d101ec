"""DQ stage/task/channel graph model.

The port's own copy of ``ydb_tpu/dq/graph.py``, over the port's
``ssa/program.py``. Mirror of the reference's distributed-query task model (dq_tasks.proto:71-
207; SURVEY.md §2.10): a query phase is a DAG of *stages*; each stage runs
N parallel *tasks* hosting a program; tasks connect through *channels*
with partitioned (HashPartition), broadcast, or merge-less (UnionAll)
routing, with credit-based flow control between compute actors.

This layer is host-mediated streaming between compiled device
programs: each task's blocks run on the device, and the channels carry
host numpy payloads between tasks.
"""

from __future__ import annotations

import dataclasses

from ydb_tpu_torch.ssa.program import Program


@dataclasses.dataclass(frozen=True)
class SourceInput:
    """Stage reads partitioned table data; task p of an N-task stage reads
    partitions p, p+N, p+2N, … so every partition is read exactly once for
    any task-count / partition-count ratio."""

    source_id: str


@dataclasses.dataclass(frozen=True)
class UnionAllInput:
    """Stage consumes every output channel of an upstream stage."""

    from_stage: int


@dataclasses.dataclass(frozen=True)
class HashPartition:
    keys: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Broadcast:
    pass


@dataclasses.dataclass(frozen=True)
class UnionAll:
    """Route every block to the consumer task (consumer stage has 1 task
    or doesn't care which task receives)."""


@dataclasses.dataclass(frozen=True)
class ResultOutput:
    pass


@dataclasses.dataclass(frozen=True)
class JoinSpec:
    """A join stage's operator: input 0 is the probe side, input 1 the
    build side; both arrive hash-partitioned on their join keys so each
    task joins its bucket device-locally (the GraceJoin shape,
    mkql_grace_join.cpp:558 — ICI/channels as the spill fabric)."""

    probe_keys: tuple[str, ...]
    build_keys: tuple[str, ...]
    payload: tuple[str, ...] = ()          # lookup join: build columns
    probe_payload: tuple[str, ...] = ()    # expand join
    build_payload: tuple[str, ...] = ()
    kind: str = "inner"  # inner | left | semi | anti (expand: inner|left)
    suffix: str = ""
    expand: bool = False  # N:M expansion vs N:1 lookup (output sized
                          # exactly from the match count)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One stage: per-block ``program`` (map/partial phase), optional
    ``final_program`` applied to the accumulated inputs (aggregate merge),
    optional ``join`` operator (two inputs: probe, build), input wiring,
    output routing and task parallelism."""

    program: Program | None
    inputs: tuple
    output: object
    tasks: int = 1
    final_program: Program | None = None
    join: JoinSpec | None = None
    # (renamed col -> dictionary source col) for program compilation
    dict_aliases: tuple[tuple[str, str], ...] = ()


@dataclasses.dataclass
class TaskSpec:
    task_id: int
    stage: int
    stage_spec: StageSpec
    partition: int
    # channel wiring filled by build_tasks
    input_channels: list[int] = dataclasses.field(default_factory=list)
    output_channels: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ChannelSpec:
    channel_id: int
    src_task: int
    dst_task: int
    # routing metadata: dst index within the consumer stage's task set —
    # hash slot p of a HashPartition output goes to the dst with
    # dst_index == p (consumer groups sort by this)
    dst_index: int
    # consumer edge: a producer feeding several consumer edges routes
    # each edge's channel group independently (full stream to each);
    # two edges from the same pair of stages stay distinct via
    # input_index (the edge's position in the consumer's inputs)
    dst_stage: int
    input_index: int = 0


def build_tasks(
    stages: list[StageSpec],
) -> tuple[list[TaskSpec], list[ChannelSpec], int]:
    """Expand stages into tasks + channels.

    Returns (tasks, channels, result_stage). The result stage must have
    exactly one task with ResultOutput.
    (reference: task graph construction kqp_tasks_graph.cpp:448,778)
    """
    tasks: list[TaskSpec] = []
    channels: list[ChannelSpec] = []
    stage_tasks: list[list[int]] = []
    next_channel = 0
    result_stage = -1
    for si, spec in enumerate(stages):
        ids = []
        for p in range(spec.tasks):
            t = TaskSpec(len(tasks), si, spec, p)
            ids.append(t.task_id)
            tasks.append(t)
        stage_tasks.append(ids)
        if isinstance(spec.output, ResultOutput):
            if result_stage >= 0 or spec.tasks != 1:
                raise ValueError("exactly one single-task result stage")
            result_stage = si
    if result_stage < 0:
        raise ValueError("no result stage")

    for si, spec in enumerate(stages):
        for ei, inp in enumerate(spec.inputs):
            if isinstance(inp, SourceInput):
                continue
            if not isinstance(inp, UnionAllInput):
                raise ValueError(inp)
            up = inp.from_stage
            up_spec = stages[up]
            consumers = stage_tasks[si]
            for src in stage_tasks[up]:
                for di, dst in enumerate(consumers):
                    ch = ChannelSpec(next_channel, src, dst, di, si, ei)
                    next_channel += 1
                    channels.append(ch)
                    tasks[src].output_channels.append(ch.channel_id)
                    tasks[dst].input_channels.append(ch.channel_id)
            if isinstance(up_spec.output, UnionAll) and len(consumers) != 1:
                raise ValueError("UnionAll output needs 1 consumer task")
    return tasks, channels, result_stage
