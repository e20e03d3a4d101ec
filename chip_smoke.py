#!/usr/bin/env python3
"""On-device smoke test of the torch/CUDA port (``ydb_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--sf 10] [--sql-sf SF] [--hits-rows 10000000]
                          [--tpcds-sf 0.1] [--storage-sql-sf 0.1]
                          [--serving-sf 0.5] [--row-sf 0.5] [--json-out PATH]
                          [--baseline-source OLD_grouped_sum.cu]

Phases, in order; any failure exits non-zero before the final line:

1. Device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Kernels: builds the CUDA kernels of ``ydb_tpu_torch/csrc`` with nvcc
   (into ``build/ydb_tpu_torch_kernels``) and holds each against its plain
   torch version on random and adversarial group ids, misaligned
   pointers, ragged row counts, slot counts at the 16-slot chunk edges,
   replays of a captured CUDA graph and back-to-back calls.
3. Main path: TPC-H Q1 and Q6 at scale factor ``--sf`` and ClickBench q33
   and q36 at ``--hits-rows`` rows, through the port's ``ScanExecutor``
   over device-resident blocks of 1<<20 rows; q33/q36 on the fused and on
   the per-aggregate group-by lowering. Launch counters are zeroed just
   before this run and read just after; each kernel must have launched.
   Results are checked against independent numpy computations.
4. Timings: warm rows/s per query; per-kernel device time at the main
   path's shape (CUDA-graph replay, so host launch overhead is out), hot
   and with inputs rotated through more than the L2 cache (cold), beside
   its plain version, ``index_add_`` and its memory bound, plus the
   host-inclusive time of one wrapper call and the device operations one
   call issues (``torch.profiler``: exactly one kernel). With
   ``--baseline-source``, an earlier kernel source is built and timed
   beside them. Then a sweep over slot counts and id mixes (one
   ``{"sweep": ...}`` line each).
5. SQL path: the 22 TPC-H queries through the port's parser, planner and
   plan walk (``execute_plan`` + ``to_host``) over all eight tables held
   on the card. First at sf 0.01, seed 11, against the rows and digests
   pinned in ``tests/golden_tpch.json``; then at ``--sql-sf`` (default:
   ``--sf``, whose seed-42 tables the scan phase already generated), where
   Q1, Q3, Q5, Q6, Q13 and Q18 are checked against independent numpy
   (Q1 and Q6 against phase 3's numpy answers of the same lineitem; the
   others' answers are kept for phase 6). One ``{"sql": ...}`` line per
   query: first-run seconds, ``SQL_WARM`` (1) warm run, result rows, peak
   device memory, the
   launches of each CUDA kernel, and for one more warm run the device's
   busy share (``torch.profiler``) and the seconds of each layer of the
   plan walk (scans, joins, transforms; synced host clock). This phase
   runs the walk (``execute_plan(..., use_dq=False)``).
6. DQ path: the 22 queries through the default routing, which sends the
   20 join-bearing plans through the DQ stage graph (``dq/compute.py``:
   credit-flow compute actors, hash-partitioned host channels, spilling).
   First at sf 0.01, seed 11 against the goldens, once at the reference's
   2 tasks and 1<<20-row blocks and once at 3 tasks and 1<<12-row blocks;
   then over phase 5's tables on the card, one ``{"sql_dq": ...}`` line
   per query: the executor that answered, stages and tasks, plan, first
   and warm seconds (eager torch: a first run compiles nothing), peak
   device memory above the tables, bytes through the channel payloads
   each way, rows hashed, parked payloads, ``spill_count``, the kernels'
   launches, the busy share and seconds per DQ layer of one more warm
   run (``dq_instruments``). Every query's first run is made, counted
   and checked: its result must equal phase 5's walk result, and Q3, Q5,
   Q13 and Q18 also equal numpy. The warm runs (three, one where the
   first run took over ``DQ_SLOW_FIRST_S``) and the profiled run are
   made while the script stays under ``DQ_EXTRAS_BUDGET_S`` (150 s), so the run
   ends inside its time limit; ``--dq-warm N`` makes them for every
   query. Phases 5 and 6 pin whole-plan fusion off
   (``plan_fuse.FUSE_FORCE = False``): at sf 0.01 it would answer every
   ``use_dq=False`` statement, and it declines the SF-10 tables anyway.
7. Whole-plan fusion (``ssa/plan_fuse.py``: one CUDA graph replay per
   statement), at the largest size the reference routes to it: every
   table at most ``FUSE_MAX_ROWS`` (131,072) rows. It runs after the DQ
   phase, so ``DQ_EXTRAS_BUDGET_S`` (counted from the script's start)
   is untouched and the run grows by this phase's own time. First the
   goldens through ``execute_plan(..., use_dq=False)`` with fusion on
   (every statement fused, each equal to the walk); then TPC-H at sf
   0.02 (120,088 lineitem rows at seed 42, all eight tables on the
   card) and the 43 ClickBench queries at 131,072 hits rows, seed 42,
   each statement fused (``use_dq=False``) and walked: one
   ``{"fused": ...}`` or ``{"clickbench": ...}`` line per query with the
   executor, fused stages, first-run and capture seconds, the medians of
   ``FUSION_WARM`` warm runs of each path and their ratio, graph replays
   per warm statement (must be 1) and grows, the CUDA kernels' launches
   (a replay counts the kernels its graph holds), device operations and
   busy share of one more warm run (``torch.profiler``), peak memory
   and the graph pools' bytes. Every fused result equals the walk's; the
   TPC-H ones equal the goldens (above) and the ClickBench ones the
   numpy canondata (``reference_answers``), also through the default
   routing (fusion for 41 queries, DQ for the two self-joined
   COUNT(DISTINCT) plans). ``GROUP BY URL`` queries on the per-aggregate
   lowering put ``grouped_sum`` inside graphs too. Then ``run_shared``
   and ``run_stacked`` at B = 4 (TPC-H q1, q6, ClickBench q33: every
   member's slice equals its serial run), and a cutoff sweep (q1, q3,
   q6, ClickBench q33 fused and walked at 16K, 64K, 131K and 1M rows,
   ``FUSE_MAX_ROWS`` raised in-process for the last point only; one
   ``{"sweep_fusion": ...}`` line each).

8. TPC-DS: the 70 queries of ``workload/tpcds.py`` at ``--tpcds-sf``
   (0.1), seed 7, every table on the card, each through the default
   routing (DQ, fusion, walk) and through the walk (``use_dq=False``,
   fusion off). Each result must equal the numpy ``reference_answers``
   (``verify_result``) and the walk's. One ``{"tpcds": ...}`` line per
   query: the executor that answered, the first run's seconds on each
   routing, peak device memory, kernel launches.
9. The ColumnShard storage path at full size (``engine/shard.py``). Phase
   3's lineitem is written into a ``ColumnShard`` over a ``DirBlobStore``
   in a temp directory with ``ColumnShard.write``/``commit`` in 1<<20-row
   chunks (``bench.py:run_ooc``'s ShardConfig: compaction off, 1<<18-row
   portion chunks and scan blocks): ingest rows/s, bytes on disk. Q1 and
   Q6 through ``shard.scan``: cold (resident tier and block cache
   emptied), one warm run after every portion was promoted (the
   resident budget keeps what fits), then with the morsel pipeline off,
   statistics off and the resident tier off (block cache on, twice). Each
   scan equals numpy and is bit-identical to the first; one
   ``{"storage_scan": ...}`` line each with rows/s, seconds per stage
   (read/merge/stage/compute), pruning counters, resident portions, rows
   and share, pipeline counters, peak device memory. Then Q6 under an
   ``l_orderkey`` range must
   skip portions and equal numpy; a second shard booted from the same
   directory (``ColumnShard.boot``) must hold the same portions and read
   Q6 back bit for bit. Phase 3's hits go into a shard too, and q33/q36
   through ``shard.scan`` on the fused and the per-aggregate lowering
   must equal phase 3's answers on the dense tier over more than 512
   groups; the CUDA kernels' launches are counted from zero over these
   four scans (``storage_launches``; each kernel must launch). One more
   run of each of the four scans then holds every kernel call against
   its plain version on the same inputs (one ``{"storage_kernel_check":
   ...}`` line each; these launches are not counted). Last, the 22 TPC-H
   queries at ``--storage-sql-sf`` (0.1; phase 10 runs SF-1 over shards
   through a Cluster) over all eight tables, each split
   over two shards by primary-key range and served as a
   ``MultiShardStreamSource`` with a ``DeviceBlockCache``, through the
   default routing (DQ takes one partition per shard) and the walk, each
   equal to the same query over host ``ColumnSource``s; one
   ``{"storage_sql": ...}`` line per query with the block cache's hits
   and misses. The shards' resident tier is off in this section, so
   table scans of the walk and of fused plans read through the block
   cache (with it on, the cache stands aside).
10. The session and serving plane (``kqp/session.py``, ``kqp/batch.py``,
   ``serving/``, ``api/pgwire.py``), on the card, through the entry points
   a user calls: a port ``Cluster(store=DirBlobStore(tmp),
   device="cuda")`` with the reference's default ``AppConfig`` (4 shards
   a table) behind ``PgWireServer(cluster, port=0)``; a minimal protocol
   3.0 client in this script sends every statement. (1) The eight TPC-H
   tables at ``--serving-sf`` (0.5) are created over the wire and loaded
   through ``ShardedTable.insert`` (the reference's bulk path); the 22
   queries run over pgwire, first and warm (``SERVING_WARM`` runs),
   each equal to ``execute_plan`` over host ``ColumnSource``s of the same
   tables (floats rtol 1e-12, everything else byte-equal); one
   ``{"serving_sql": ...}`` line per query (executor, first and warm
   seconds, plan- and compile-cache status, rows, peak device memory).
   (2) ClickBench hits at 131,072 rows (``FUSE_MAX_ROWS``): the 43
   queries over pgwire, each equal to ``reference_answers``; one
   ``{"serving_clickbench": ...}`` line each. (3) The batched tier:
   ``BATCH_CLIENTS`` connections send q33 at once, rounds at window 0
   and at ``BATCH_WINDOW_MS`` (2 ms) in turns (statements/s, p50/p99;
   dedup dispatches > 0; every answer equal); then, with the window at
   ``STACKED_WINDOW_MS``, hits reloaded short of its shape class's top
   and, for q33, q36 and q38, four connections send the query, a ninth
   inserts rows, four more send it: one group over two snapshots, one
   ``run_stacked`` dispatch; every SELECT is held byte for byte against
   the serial path at the snapshot it read; graph captures per batch
   size and the graph pools' bytes before and after an invalidation
   (after: 0). The CUDA kernels' launches are counted from step (1) to
   here (``serving_launches``; ``grouped_sum_multi`` must launch).
   (4) q33 and q36 through a Session on the per-aggregate lowering with
   fusion off, every kernel call held against its plain version
   (``{"serving_kernel_check": ...}``; not counted). (5) Eight threads run
   walk, DQ and fused statements through Sessions while a ninth captures
   a plan not seen before; every result equals its serial answer. (6)
   Tenants ``gold`` (weight 3) and ``bronze`` (weight 1, one seat, no
   queue) behind ``serving.install``: connections naming a tenant are
   admitted under it, an over-cap one is shed with an error naming the
   pool, the per-tenant p50/p99 gauges are filled. (7) A second Cluster
   booted from the same directory answers Q1, Q6 and q33 byte for byte
   over a new server. (8) The 22 golden digests at sf 0.01 through a
   third Cluster over pgwire.
11. The sanitizers (``ydb_tpu_torch/analysis``): tsan, leaksan, syncsan
   and memsan armed through their ``activate()`` (no fallback: a seam
   that does not install, or a CUDA sync debug mode other than "warn",
   fails the run), then TPC-H Q1 and Q6 through ``ScanExecutor`` over
   phase 3's lineitem (its read columns held on the card), each equal to
   the same run unsanitized (floats rtol 1e-12); a Cluster booted from
   phase 10's store, under tsan's tracked locks, answers Q1, Q6, q3 (DQ),
   q33 and q36 (fused) over pgwire; one batched q33 round of
   ``BATCH_CLIENTS`` connections; the armed q33 runs below; q33 and q36
   with fusion off on the per-aggregate lowering (``grouped_sum``); each
   equal to phase 10's unsanitized answer. The CUDA kernels' launches are
   counted from the boot to here (``sanitize_launches``; both must
   launch). Then q33 and q36 on both group-by lowerings with every kernel
   call held against its plain version (not counted); ``Cluster.stop``. Each statement runs once
   (the free pass) and ``SANITIZE_WARM`` times warm, one
   ``{"sanitize": ...}`` line each: syncs the seams saw and the ones the
   debug mode saw, H2D and D2H copies, graph captures, kernel builds,
   ``compile_program`` calls, memsan's charged peak and unbudgeted
   allocations, the allocator's peak (``max_memory_allocated`` after
   ``reset_peak_memory_stats``, single-threaded), the leak handles live
   and the race reports. It fails on a capture, build or compile in a
   warm statement, an unbudgeted allocation, a leak at ``Cluster.stop``,
   a race report, a result unequal to the unsanitized one, or a kernel
   unlaunched. ``{"sanitize_overhead": ...}``: warm q33 over pgwire,
   disarmed (phase 10's cluster) and armed medians; the disarmed one
   within ``SANITIZE_NOISE`` of phase 10's warm q33. Under
   ``SANITIZE_BUDGET_S`` (90 s).
12. Chaos and the timeline (``ydb_tpu_torch/chaos``, ``obs/timeline.py``,
   ``obs/probes.py``, ``obs/kernelbench.py``), over phase 9's lineitem and
   hits shards (booted from their directory) and a Cluster booted from
   phase 10's store. Timeline, forced on into a ring of
   ``TIMELINE_EVENTS``: a cold and a warm Q1 (resident tier filled
   between) and a warm q33 from the shards, profiled; one
   ``{"timeline_query": ...}`` line each with events, drops, busy
   seconds and fraction per stage, ``movement|compute``, and the ring's
   per-stage sums, which must equal ``StageTimer``'s within
   ``TIMELINE_REL``; a warm fused q33 through the Cluster adds its
   ``plan.dispatch`` interval; the Chrome trace goes to
   ``build/phase12_trace.json``. Chaos, seed ``CHAOS_SEED``:
   ``blob.get_range`` ``io_error`` at p=0.05 on cold Q1 and Q6 (resident
   tier off, block cache cleared), each bit-identical to the unfaulted
   scan, the retries counted; ``resident.lookup`` faults on q33 and q36
   on both group-by lowerings, bit-identical, the kernels' launches
   counted over these scans (both must launch; read before the check
   that then holds every call of the same four scans against the plain
   versions), one of them under memsan (0 unbudgeted); ``conveyor.task``
   ``worker_death`` (the pool respawns, ``wait_idle`` drains to depth
   0); then, under leaksan from the Cluster's boot to its stop:
   ``fuse.trace`` on fused q33 (the walk answers, then one capture),
   ``session.admit`` ``overload`` (``OverloadedError``),
   ``noisy_neighbor.json`` over pgwire behind a gold and a bronze tenant
   (every answer equal to phase 10's, the shed counted), and the deadline
   scenario: TPC-H Q1/Q3/Q6 twice with ``blob.get_range`` faults at
   p=0.05 and the fifth statement past its deadline
   (``StatementCancelled``, ``error_reason == "cancelled"``), the rest
   equal to phase 10's; no leak handle, no promotion flight left. One
   ``{"timeline": ...}``, one ``{"chaos": ...}`` and one
   ``{"kernelbench": ...}`` line: the group-by at 1<<20 rows and 1,745
   groups on both lowerings against the CPU oracle, and the chaos and
   profiling overheads on warm Q1 at SF-1 (one shard for both) within
   the reference's budgets (``KB_CHAOS_BUDGET``, ``KB_PROFILE_BUDGET``):
   the armed chaos sites and a profiled scan's trace work counted and
   timed, the ring over ``KB_PROFILE_ITERS`` interleaved rounds. Each
   step's seconds are printed before the phase's time is asserted.
   Under ``CHAOS_BUDGET_S`` (120 s).
13. The row store (``ydb_tpu_torch/datashard``, ``tx/mediator.py``, the
   row DML and interactive transactions of ``kqp/session.py``), in a
   Cluster over a ``DirBlobStore`` on the card. Load: TPC-H at
   ``--row-sf`` (default ``ROW_SF`` = 0.5) with ``orders`` as a row table
   of ``ROW_SHARDS`` DataShards (750,000 rows in INSERT batches of
   ``ROW_LOAD_BATCH``; the load rate printed), customer and lineitem as
   column tables. Analytics, first (the row table walked, as after a
   commit), warm (its source reused) and once under syncsan (0 captures,
   builds and compiles): GROUP BY o_orderdate (about
   1,096 groups, the sorted tier) and GROUP BY o_comment (about 1,960
   dictionary groups, the dense tier of the CUDA kernels), each once more
   on the per-aggregate lowering with fusion off, and TPC-H q3, q4 and
   q13 reading orders from the row table; launch counters zeroed before
   these runs and read after (both kernels must launch); every answer
   equal to an all-column cluster of the same data and to numpy (the
   GROUP BYs through ``engine/oracle.py``); then the o_comment GROUP BY's
   kernel calls on both lowerings held against the plain versions (not
   counted). Transactions on ``accounts`` (``ACCOUNTS`` rows in
   ``ACCOUNT_SHARDS`` shards, a secondary index on branch):
   ``TX_SESSIONS`` sessions on threads run ``TX_ROUNDS`` rounds of
   ``TX_PER_ROUND`` interactive transfers (BEGIN, two UPDATEs, COMMIT,
   retried on abort) with autocommit INSERT / UPDATE /
   DELETE and index lookups between; SUM(balance) on the card after
   every round never changes (its warm read builds, captures and compiles
   nothing); the balances at the end equal a serial replay of the
   committed transfers. Reboot: a new Cluster from the same directory
   reads the o_comment GROUP BY and every balance back equal. One
   ``{"row_statement": ...}`` line per statement run and one
   ``{"row_store": ...}`` line (load rate, first and warm ms and
   ``source_at``'s share of each, commits, aborts and
   retries, launches, reboot). Under ``ROW_STORE_BUDGET_S`` (240 s).
14. Monitoring, coordination and load (``obs/sysview.py``,
   ``obs/viewer.py``, ``obs/loadtest.py``, ``tablet/kesus.py``,
   ``runtime/quoter.py``); it runs after phase 12, on phase 10's store.
   A Cluster booted from it behind pgwire, with a ``Viewer`` on port 0.
   (1) Launch counters zeroed; Q1, Q6, q3, q33 and q36 over pgwire, then
   q33 and q36 on the per-aggregate lowering with fusion off, each equal
   to phase 10's answer; both kernels must launch (``monitor_launches``),
   then every kernel call of q33 and q36 is held against its plain version
   (``serving_kernels``; not counted). (2) ``MONITOR_CLIENTS``
   connections loop over q33 and q3 for ``MONITOR_LOAD_S`` (every answer
   equal to phase 10's) while a ninth polls ``sys_active_queries`` over
   pgwire (each poll sees its own statement) and
   ``/viewer/json/timeline``; after the load the view holds exactly the
   statement that reads it. (3) Each of the 15 sys views read through
   ``/viewer/json/sysview`` and then with ``SELECT *`` over pgwire: equal
   rows but for the memory values of ``sys_memory`` and
   ``sys_device_memory`` (the pgwire read of ``sys_active_queries`` also
   holds its own statement); its build, endpoint and pgwire milliseconds.
   Per table, ``sys_partition_stats`` rows sum to ``sys_table_stats``'s
   rows and to ``COUNT(*)``, for TPC-H the rows phase 10 loaded;
   ``sys_top_queries`` rank 1 at least as slow as every row of
   ``sys_query_log``; memsan armed for one q33, the ``<global>`` row of
   ``sys_device_memory`` has live <= peak <= ``max_memory_allocated``;
   health GOOD; ``/counters/prometheus`` parses. (4) ``LoadService``
   (seed ``LOAD_SEED``): ``kv_upsert``, ``select`` and ``storage_put`` at
   ``LOAD_REQUESTS`` each, 0 errors, p50 <= p90 <= p99. (5) ``CREATE
   SEQUENCE`` over pgwire; ``SEQ_CLIENTS`` connections each INSERT
   ``SEQ_ROWS`` rows with ``nextval`` into a row table, all distinct; a
   Cluster booted again from the directory hands out a higher value;
   after ``DROP SEQUENCE`` ``nextval`` raises. (6) ``Cluster.quoter`` at
   ``QUOTER_BURST`` / ``QUOTER_RATE`` on ``kqp/requests``:
   ``QUOTER_STATEMENTS`` statements back to back, the admitted at most the
   burst plus rate x elapsed plus 1, the rest ``ThrottledError`` and
   counted under ``kind="throttled"``. One ``{"monitor": ...}`` line.
   Under ``MONITOR_BUDGET_S`` (60 s).
15. The gRPC front (``api/server.py``, ``api/client.py``, ``api/arrow_io.py``,
   ``blocks/arrow_bridge.py``, ``runtime/console.py``); it runs after phase
   14, on phase 10's store. A Cluster booted from it behind
   ``make_server(cluster, port=0)`` and a port ``Driver``. (2) Query
   service: launch counters zeroed; Q1, Q6, q3 (DQ), q33 and q36, then
   q33 and q36 on the per-aggregate lowering with fusion off, each Arrow
   result equal to phase 10's pgwire answer (floats rtol 1e-12); both
   kernels must launch (``grpc_launches``), then every kernel call of q33
   and q36 is held against its plain version (``serving_kernels``; not
   counted). (3) Table service: ``CREATE TABLE``, BulkUpserts of
   ``GRPC_UPSERT_ROWS`` Arrow rows (int64, string, float64, decimal, date)
   in ``GRPC_UPSERT_BATCH``-row calls,
   ReadTable streamed back in ``GRPC_FRAME_ROWS``-row frames equal to them,
   COUNT and SUM equal; on a row table an interactive transaction that
   commits, one that rolls back, and ``DeleteSession`` with one open
   rolling it back. (4) ``ListDirectory`` and ``DescribeTable`` of every
   TPC-H table and its ``COUNT(*)`` equal to the rows phase 10 loaded; an
   asynchronous export of customer polled through the Operation service,
   imported under a new name; a Scripting script's COUNT and
   SUM(c_acctbal) of the copy equal the original's. (5) A Coordination
   semaphore held by one session refuses a second until released;
   ``GRPC_RL_CALLS`` RateLimiter acquisitions grant at most burst + rate x
   elapsed + 1; a Cms config reads back with its version, a stale one is
   refused; health GOOD; a second server with ``auth_tokens`` refuses a
   bad ticket (``UNAUTHENTICATED``); a KeyValue RPC answers
   ``UNIMPLEMENTED`` naming ROADMAP.md queue A item 12. (6)
   ``GRPC_CLIENTS`` client threads send q6 and q33 for ``GRPC_LOAD_S``,
   every answer equal to (2): statements/s and p50/p99 on the client's
   clock. (7) The node's first maintenance pass (``run_background`` under
   the server's lock, as ``cli.py serve``'s loop runs it; on a store just
   booted it sketches every column table for statistics); phase 16 goes
   on on this node. One ``{"grpc": ...}`` line with each step's seconds, printed
   before the phase's time is asserted. Under ``GRPC_BUDGET_S`` (60 s).
16. Streaming (``topic/``, changefeeds, ``replication.py``, ``fq/``,
   ``api/kafka.py``, ``api/sqs.py``, the gRPC Topic service, ``cli.py``);
   it runs after phase 15, on phase 15's node (a Cluster booted from
   phase 10's store behind ``make_server``), with a ``KafkaServer`` and
   an ``SqsHttpServer`` added (port 0, the gRPC server's lock). (1)
   ``STREAM_EVENTS`` ClickBench-shaped JSON events (URL,
   ResolutionWidth, EventTime of the port's generator at
   ``STREAM_SEED``, in event-time order, ``STREAM_LATE_EVENTS`` of them
   stamped in the first window and written after 60% of the rest) into a
   ``STREAM_PARTITIONS``-partition topic in ``STREAM_WRITE_BATCH``-message
   writes with producer seqnos; ``STREAM_SQL`` (GROUP BY URL) as a
   ``StreamingQuery`` on the card in ``STREAM_BATCH_LIMIT``-rows-a-
   partition polls, every micro-batch over more than 512 groups, launch
   counters zeroed before and read after both runs: once on the fused
   lowering (default routing: a fused dispatch a batch; poll
   ``STREAM_CRASH_POLL`` crashes between its sink write and its
   checkpoint, and the query rebuilt from the checkpoint replays it with
   every emission once in the sink) and once on the per-aggregate
   lowering with fusion off; both kernels must launch
   (``stream_launches``); each ``results()`` equals the group-by on the
   host of all events (integers exact); one micro-batch's kernel calls on
   both lowerings held against the plain versions (not counted); a
   tumbling-window query (``STREAM_WINDOW_US``, ``STREAM_LATENESS_US``)
   emits each (window, URL) once, equal to the host's group-by of the
   on-time events, and counts the late ones. (2) A ``changefeed = on``
   row table of ``STREAM_CDC_ROWS`` rows in ``STREAM_CDC_SHARDS`` shards
   takes an UPSERT, an UPDATE and a DELETE; ``run_background``'s
   ``cdc_shipped`` sums to the changes made; a ``Replicator`` tails the
   changefeed into a replica whose ``SELECT`` on the card equals the
   source's; a change whose ack is lost, re-shipped, is dropped by its
   producer seqno. (3) ``STREAM_KAFKA_MSGS`` keyed messages in Produce
   v2 batches of ``STREAM_KAFKA_BATCH`` through a minimal Kafka client,
   fetched back equal; a consumer group's OffsetCommit read back by
   OffsetFetch; a bad CRC refused. (4) SQS: CreateQueue,
   ``STREAM_SQS_MSGS`` SendMessage, ReceiveMessage and DeleteMessage; a
   message left undeleted past its ``STREAM_SQS_LEASE_S`` lease comes
   back; the queue ends empty. (5) A gRPC Topic Write/Read/Commit round
   trip of ``STREAM_GRPC_MSGS`` messages; a StreamRead of the changefeed
   equal to a direct read; the port CLI's ``topic write`` and ``topic
   read`` in process. (6) The fronts and the node stop; a Cluster
   booted again from the directory reads the changefeed's offsets and
   the replica's commits back. One ``{"streaming": ...}`` line with each
   step's seconds, printed before the phase's time is asserted. Under
   ``STREAM_BUDGET_S`` (45 s).
17. SQL on a degraded erasure group (``ydb_tpu_torch/blobstorage``,
   ``runtime/failpoints.py``); it runs after phase 13. A block-4-2
   ``GroupInfo`` of six ``VDisk``s, each an ``LsmBlobStore`` on its own
   ``PDisk`` file (``ERASURE_CHUNK``-byte chunks, ``ERASURE_MEMTABLE``
   memtables) in a temporary directory, a ``BSController`` with two spare
   disks on a ``NodeWarden``, and a Cluster on the card over
   ``GroupBlobStore(DSProxy(group))``; the codec's encodes and decodes and
   the store's reads are counted and timed from outside. (1) Load: TPC-H at
   ``ERASURE_SF`` (eight tables) and ``ERASURE_HITS_ROWS`` ClickBench hits
   rows created and bulk loaded, the hulls flushed; rows/s, live bytes on
   each disk, live and PDisk chunk bytes written over raw bytes, encode
   MB/s, the largest part. (2) Healthy: health GOOD; launch counters
   zeroed; Q1, Q6 and q3 under the default routing, q33 and q36 on the
   fused and on the per-aggregate lowering (``kernels.FUSED_FORCE`` True and
   False); both kernels must launch (``erasure_launches``); Q1, Q6 and q3
   equal numpy (``check_sql_q1``/``_q6``/``_q3``), q33 and q36
   ``q33_q36_answers``; then q33 and q36 with every kernel call held
   against its plain version (``serving_kernels``; not counted). (3)
   Degraded: disks 0 and 3 down, health DEGRADED with the reference's
   message; the Cluster stops, the live hulls reopen from their files
   (manifest, WAL replay) and a new Cluster boots from the degraded group;
   every answer equals step 2's; a table created and written while
   degraded reads back; restore MB/s, bytes decoded against bytes returned
   and decodes per blob read. (4) Heal: ``check_and_heal`` puts both spares
   in, health GOOD; disks 1 and 4 down, a new Cluster boots, every answer
   equals step 2's; one more row written and read back. (5) Beyond the
   quorum: disk 2 down too (three), health EMERGENCY; with the device
   tiers emptied TPC-H Q6 raises the ``DSProxy``'s ``ValueError`` (or
   ``KeyError``) and answers nothing; the disks return, ``resync``
   repatriates the parts written while 1 and 4 were down (more than 0),
   Q6 equals step 2's again and every written row reads back. (6)
   Failpoints: the group store behind ``FailpointBlobStore``, ``blob.get``
   armed ``times`` ``ERASURE_FAULTS``: that many Cluster boots fail soft
   with ``InjectedFault``, the next answers q33 equal to step 2's;
   ``stats()`` printed. Each step's seconds on its own line and one
   ``{"erasure": ...}`` line, printed before the phase's time is asserted.
   Under ``ERASURE_BUDGET_S`` (60 s).

Phases run 1-12, 14, 15, 16, 13, 17.

The last lines are a ``{"phase_seconds": {...}}`` JSON line (each phase's
seconds, also in ``--json-out``), a ``{"metrics": ...}`` line, a
``{"kernels": [...]}`` JSON line, the nvidia-smi line and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM HBM3 bandwidth (NVIDIA data sheet), for the memory bound
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet)
F32_OPS_PER_S = 67e12
BLOCK_ROWS = 1 << 20
#: inputs rotated through for a cold-cache time: more than the H100's
#: 50 MB L2 several times over
L2_COLD_BYTES = 200 << 20
KERNEL_SOURCE = "ydb_tpu_torch/csrc/grouped_sum.cu"
REPLACES = {
    "grouped_sum_multi": "ydb_tpu/ssa/pallas_kernels.py:138",
    "grouped_sum": "ydb_tpu/ssa/pallas_kernels.py:78",
}


STARTED = time.perf_counter()


def log(msg: str) -> None:
    """A progress line, stamped with the seconds since the script began."""
    print(f"[{time.perf_counter() - STARTED:7.1f} s] {msg}", flush=True)


class PhaseClock:
    """Each phase's seconds of script time, keyed by phase: ``lap(name)``
    closes the phase that ran since the previous lap (the first lap
    counts from the script's start)."""

    def __init__(self):
        self.seconds: dict = {}
        self._last = STARTED

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._last
        self._last = now
        log(f"phase {name}: {self.seconds[name]:.1f} s")


def emit(obj: dict) -> None:
    """A JSON line of results (no stamp, so it parses as it stands)."""
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, repeats: int = 5) -> float:
    """Host-inclusive time of one call: median over ``repeats`` of the
    mean CUDA-event time of ``iters`` back-to-back calls, after a warm-up
    (small kernels are then bound by the host's launch rate)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def device_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured into a CUDA
    graph, replayed ``repeats`` times under CUDA events; the median
    replay over ``iters``. Host launch overhead is not in it. ``fn`` may
    be a list of calls on different inputs: the graph then cycles
    through them (``iters`` is rounded up to a multiple of their count),
    so that the inputs, when they outgrow the L2 cache, are read cold."""
    fns = fn if isinstance(fn, list) else [fn]
    iters = -(-iters // len(fns)) * len(fns)
    fns[0]()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns[:3]:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def cold_sets(tensors, set_bytes: int) -> list:
    """Copies of ``tensors`` that together exceed the L2 cache (at least
    8 sets, and at least L2_COLD_BYTES in all)."""
    n = max(8, -(-L2_COLD_BYTES // set_bytes))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def bound(rows: int, slots: int, ng: int) -> tuple[float, str]:
    """Least device ms for one grouped sum: ids and values read once,
    the (groups x slots) output written once, at HBM rate; or one add
    per value at the float32 rate, whichever is larger."""
    bytes_ms = (rows * 4 + rows * slots * 4 + ng * slots * 4) \
        / HBM_BYTES_PER_S * 1e3
    ops_ms = rows * slots / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def sweep(ck, baseline, url_ids, ng, dev) -> list:
    """Kernel device times at 1<<20 rows over slot counts and id mixes
    (zipf URL ids as on the main path, uniform ids, one hot id), hot
    (inputs in L2) and cold (inputs rotated through more than L2); int32
    values, and float32 at 1 and 6 slots."""
    rows = url_ids.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    mixes = {
        "zipf": url_ids,
        "uniform": torch.randint(0, ng, (rows,), generator=gen, device=dev,
                                 dtype=torch.int32),
        "hot": torch.full((rows,), 7, dtype=torch.int32, device=dev),
    }
    out = []
    for mix, g in mixes.items():
        for name, slots, dtype in (
                ("grouped_sum_multi", 1, torch.int32),
                ("grouped_sum_multi", 6, torch.int32),
                ("grouped_sum_multi", 17, torch.int32),
                ("grouped_sum_multi", 128, torch.int32),
                ("grouped_sum", 1, torch.int32),
                ("grouped_sum_multi", 1, torch.float32),
                ("grouped_sum_multi", 6, torch.float32)):
            shape = (rows, slots) if name == "grouped_sum_multi" else (rows,)
            v = torch.randint(-1000, 1000, shape, generator=gen, device=dev,
                              dtype=torch.int32).to(dtype)
            kfn = getattr(ck, name)
            sets = cold_sets((v, g), v.nbytes + g.nbytes)
            row = {"kernel": name, "slots": slots, "ids": mix,
                   "dtype": str(dtype).removeprefix("torch."), "rows": rows,
                   "groups": ng,
                   "ms": device_ms(lambda: kfn(v, g, ng)),
                   "cold_ms": device_ms([
                       (lambda vv=vv, gg=gg: kfn(vv, gg, ng))
                       for vv, gg in sets])}
            if baseline:
                bfn = baseline[name]
                row["baseline_ms"] = device_ms(lambda: bfn(v, g, ng))
                row["baseline_cold_ms"] = device_ms([
                    (lambda vv=vv, gg=gg: bfn(vv, gg, ng)) for vv, gg in sets])
            row["bound_ms"], row["bound_by"] = bound(rows, slots, ng)
            row["bound_share"] = row["bound_ms"] / row["cold_ms"]
            del sets
            out.append(row)
            emit({"sweep": row})
    return out


# ---------------- phase 2: kernels against their plain versions ----------------


def kernel_phase(ck, dev) -> dict:
    t0 = time.perf_counter()
    lib = ck.build(verbose=True)
    log(f"kernels built: {os.path.relpath(lib, HERE)} in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    err = {"grouped_sum": 0.0, "grouped_sum_multi": 0.0}
    n_cases = {"grouped_sum": 0, "grouped_sum_multi": 0}

    def values(rows, slots, dtype, kind):
        shape = (rows, slots) if slots else (rows,)
        if kind == "int_floats":  # exact in f32 whatever the order
            return torch.randint(0, 16, shape, generator=gen, device=dev
                                 ).to(dtype)
        if kind == "wrap":  # int32 sums that overflow and wrap
            return torch.full(shape, 1 << 30, dtype=dtype, device=dev)
        if dtype == torch.int32:
            return torch.randint(-1000, 1000, shape, generator=gen,
                                 device=dev, dtype=torch.int32)
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    def gids(rows, ng, kind):
        if kind == "all_dropped":
            return torch.full((rows,), ng, dtype=torch.int32, device=dev)
        if kind == "hot":
            return torch.full((rows,), 7 % ng, dtype=torch.int32, device=dev)
        if kind == "out_of_range":  # negatives, == ng and > ng mixed in
            return torch.randint(-3, ng + 6, (rows,), generator=gen,
                                 device=dev, dtype=torch.int32)
        return torch.randint(0, ng + 1, (rows,), generator=gen, device=dev,
                             dtype=torch.int32)

    def check(name, got, want, dtype, label):
        torch.cuda.synchronize()
        if dtype == torch.int32:
            if not torch.equal(got, want):
                bad = (got.long() - want.long()).abs().max().item()
                raise AssertionError(f"{name} {label}: int32 mismatch {bad}")
        else:
            # float32 sums differ only in summation order: rtol 1e-5
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                       msg=f"{name} {label}")
            err[name] = max(err[name], (got - want).abs().max().item())
        n_cases[name] += 1

    # (rows, groups, dtype, id kind, value kind, (id offset, value
    # offset)): an offset of 1 or 2 elements moves a pointer off 16-byte
    # alignment; unequal offsets put ids and values in different phases
    aligned = (0, 0)
    cases = []
    for ng in (513, 1749, 2048):
        for dtype in (torch.int32, torch.float32):
            cases.append((BLOCK_ROWS, ng, dtype, "random", "random", aligned))
    # phase 9's GROUP BY URL shard scans: scan blocks of
    # STORAGE_BLOCK_ROWS over the URL dictionary's 1,745 groups
    for dtype in (torch.int32, torch.float32):
        for gk in ("random", "out_of_range"):
            cases.append((STORAGE_BLOCK_ROWS, 1745, dtype, gk, "random",
                          aligned))
    for dtype in (torch.int32, torch.float32):
        vk = "int_floats" if dtype == torch.float32 else "random"
        cases += [
            (BLOCK_ROWS, 1749, dtype, "all_dropped", "random", aligned),
            (BLOCK_ROWS, 1749, dtype, "hot", vk, aligned),
            (BLOCK_ROWS, 1749, dtype, "out_of_range", "random", aligned),
            (BLOCK_ROWS - 333, 1749, dtype, "random", "random", aligned),
            (1000, 513, dtype, "out_of_range", "random", aligned),
            (BLOCK_ROWS + 3, 1749, dtype, "random", "random", (1, 1)),
            (BLOCK_ROWS + 3, 1749, dtype, "out_of_range", "random", (1, 2)),
            (BLOCK_ROWS, 2048, dtype, "hot", vk, (3, 3)),
        ]
        for rows in (1, 3, 4095):
            for offs in (aligned, (1, 1), (2, 1)):
                cases.append((rows, 1749, dtype, "out_of_range", "random",
                              offs))
    # more rows than one cluster's share, all in one group: int32 wraps
    cases.append((BLOCK_ROWS, 1749, torch.int32, "hot", "wrap", aligned))
    cases.append((BLOCK_ROWS + 3, 1749, torch.int32, "hot", "wrap", (1, 1)))
    for rows, ng, dtype, gk, vk, (go, vo) in cases:
        g = gids(rows + go, ng, gk)[go:]
        for slots in (1, 6, 16, 17, 32, 128):
            v = values(rows + vo, slots, dtype, vk)[vo:]
            label = (f"rows={rows} groups={ng} slots={slots} {dtype} "
                     f"{gk}/{vk} offsets={go},{vo}")
            check("grouped_sum_multi", ck.grouped_sum_multi(v, g, ng),
                  ck.grouped_sum_multi_plain(v, g, ng), dtype, label)
        v = values(rows + vo, 0, dtype, vk)[vo:]
        check("grouped_sum", ck.grouped_sum(v, g, ng),
              ck.grouped_sum_plain(v, g, ng), dtype,
              f"rows={rows} groups={ng} {dtype} {gk}/{vk} offsets={go},{vo}")

    # one call captured into a CUDA graph and replayed three times: each
    # replay must equal the plain version (the launch's ticket resets);
    # then two calls back to back on one stream with other group counts
    g = gids(BLOCK_ROWS + 1, 2048, "random")[1:]
    for name, slots, kfn, pfn in (
            ("grouped_sum_multi", 17, ck.grouped_sum_multi,
             ck.grouped_sum_multi_plain),
            ("grouped_sum_multi", 1, ck.grouped_sum_multi,
             ck.grouped_sum_multi_plain),
            ("grouped_sum", 0, ck.grouped_sum, ck.grouped_sum_plain)):
        v = values(BLOCK_ROWS + 1, slots, torch.int32, "random")[1:]
        kfn(v, g, 1749)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = kfn(v, g, 1749)
        want = pfn(v, g, 1749)
        for i in range(3):
            got.fill_(-1)
            graph.replay()
            check(name, got, want, torch.int32,
                  f"CUDA graph replay {i} slots={slots}")
        a, b = kfn(v, g, 513), kfn(v, g, 2048)
        check(name, a, pfn(v, g, 513), torch.int32,
              f"back to back, 513 groups slots={slots}")
        check(name, b, pfn(v, g, 2048), torch.int32,
              f"back to back, 2048 groups slots={slots}")
    log(f"kernel phase: {n_cases} cases agree with the plain versions; "
        f"max |kernel - plain| (float32) {err}")
    return err


def profiled(fn, attempts: int = 3):
    """(profile, wall seconds) of one call of ``fn`` under
    ``torch.profiler``, the call ending in a device sync. A window that
    recorded no device event at all is a profiler miss (every caller's
    call launches device work): it is taken again, up to ``attempts``
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            break
    return prof, wall


def device_kernels_of_one_call(fn) -> list:
    """Names of the device operations (kernels, memsets, copies) that
    one warm call of ``fn`` issues, from a ``torch.profiler`` window."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    prof, _ = profiled(fn)
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def load_baseline(ck, source: str):
    """An earlier grouped_sum.cu with the zero-filled-output interface
    (``ydb_grouped_sum_multi(values, gid, out, rows, slots, groups,
    dtype, stream)``, ``ydb_grouped_sum(values, gid, out, rows, groups,
    dtype, stream)``), built with the same nvcc flags and wrapped as its
    callers did: ``torch.zeros`` for the output, then the launch."""
    import ctypes
    import hashlib

    src = open(source, "rb").read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = ck.BUILD_DIR / f"libbaseline_{tag}.so"
    ck.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-o", str(so), source],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ydb_grouped_sum_multi.argtypes = [p, p, p, ll, i, i, i, p]
    lib.ydb_grouped_sum.argtypes = [p, p, p, ll, i, i, p]
    lib.ydb_grouped_sum_multi.restype = lib.ydb_grouped_sum.restype = i
    code = {torch.int32: 0, torch.float32: 1}

    def multi(values, gid, ng):
        out = torch.zeros((ng, values.shape[1]), dtype=values.dtype,
                          device=values.device)
        rc = lib.ydb_grouped_sum_multi(
            values.data_ptr(), gid.data_ptr(), out.data_ptr(),
            values.shape[0], values.shape[1], ng, code[values.dtype],
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    def single(values, gid, ng):
        out = torch.zeros((ng,), dtype=values.dtype, device=values.device)
        rc = lib.ydb_grouped_sum(
            values.data_ptr(), gid.data_ptr(), out.data_ptr(),
            values.shape[0], ng, code[values.dtype],
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    return {"grouped_sum_multi": multi, "grouped_sum": single}


# ---------------- phase 3: the main path ----------------


def numpy_q1(li, cutoff):
    """Q1 by plain numpy, exact in int64: {(rf, ls): (count, sums...)}."""
    m = li["l_shipdate"] <= cutoff
    rf = li["l_returnflag"][m].astype(np.int64)
    ls = li["l_linestatus"][m].astype(np.int64)
    qty, price = li["l_quantity"][m], li["l_extendedprice"][m]
    disc, tax = li["l_discount"][m], li["l_tax"][m]
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    gid = rf * 8 + ls
    out = {}
    for g in np.unique(gid):
        sel = gid == g
        out[(int(g // 8), int(g % 8))] = {
            "count_order": int(sel.sum()),
            "sum_qty": int(qty[sel].sum()),
            "sum_base_price": int(price[sel].sum()),
            "sum_disc_price": int(disc_price[sel].sum()),
            "sum_charge": int(charge[sel].sum()),
            "sum_disc": int(disc[sel].sum()),
        }
    return out


def check_q1(res, want) -> None:
    c = res.cols
    n = res.num_rows
    assert n == len(want), (n, len(want))
    for i in range(n):
        key = (int(c["l_returnflag"][0][i]), int(c["l_linestatus"][0][i]))
        w = want[key]
        for col in ("count_order", "sum_qty", "sum_base_price",
                    "sum_disc_price", "sum_charge"):
            assert int(c[col][0][i]) == w[col], (key, col)
        cnt = w["count_order"]
        for col, num, scale in (("avg_qty", "sum_qty", 100),
                                ("avg_price", "sum_base_price", 100),
                                ("avg_disc", "sum_disc", 100)):
            np.testing.assert_allclose(  # f64 averages: rtol 1e-12
                float(c[col][0][i]), w[num] / scale / cnt, rtol=1e-12)


def numpy_q6(li, d0, d1) -> int:
    m = ((li["l_shipdate"] >= d0) & (li["l_shipdate"] < d1)
         & (li["l_discount"] >= 5) & (li["l_discount"] <= 7)
         & (li["l_quantity"] < 2400))
    return int(np.sum(li["l_extendedprice"][m] * li["l_discount"][m]))


def stage(src, programs, dev):
    """Executors for ``programs`` plus ONE device-resident copy of the
    blocks holding every column any of them reads."""
    from ydb_tpu_torch.engine.scan import ScanExecutor

    exs = [ScanExecutor(p, src, block_rows=BLOCK_ROWS, device=dev)
           for p in programs]
    cols = tuple(dict.fromkeys(c for ex in exs for c in ex.read_cols))
    t0 = time.perf_counter()
    blocks = list(src.blocks(BLOCK_ROWS, cols, device=dev))
    torch.cuda.synchronize()
    return exs, blocks, time.perf_counter() - t0


# ---------------- phase 5: the SQL path ----------------


def sql_database(tp, dev):
    """A port Database over all eight tables of ``tp``, held on ``dev``,
    and the planner's catalog."""
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.plan import Database
    from ydb_tpu_torch.sql.planner import Catalog
    from ydb_tpu_torch.workload import tpch

    db = Database(
        sources={t: ColumnSource(c, tp.schema(t), tp.dicts).to_device(dev)
                 for t, c in tp.tables.items()},
        dicts=tp.dicts, device=dev)
    catalog = Catalog(schemas={t: tp.schema(t) for t in tp.tables},
                      primary_keys=dict(tpch.PRIMARY_KEYS), dicts=tp.dicts)
    return db, catalog


def plan_sql(sql, db, catalog, use_dq=None):
    """Plan one statement; uncorrelated scalar subqueries run on the
    device while it plans (the reference's precompute phase), routed as
    ``use_dq`` says (None: the default routing, DQ for joins)."""
    from ydb_tpu_torch.plan import execute_plan, to_host
    from ydb_tpu_torch.sql.parser import parse
    from ydb_tpu_torch.sql.planner import plan_select_full

    def scalar_exec(plan, t):
        out = to_host(execute_plan(plan, db, use_dq=use_dq))
        v, ok = out.cols[out.schema.names[0]]
        assert len(v) == 1, f"scalar subquery returned {len(v)} rows"
        return v[0].item(), bool(ok[0])

    return plan_select_full(parse(sql), catalog, scalar_exec)


def run_sql(pq, db, use_dq=None):
    from ydb_tpu_torch.plan import execute_plan, to_host

    res = to_host(execute_plan(pq.plan, db, use_dq=use_dq))
    if db.device is not None and torch.device(db.device).type == "cuda":
        torch.cuda.synchronize()
    res.dict_aliases = pq.dict_aliases
    return res


def golden_digest(out, dicts, fields=None) -> str:
    """sha256 of a result as tests/test_tpch_sql.py pins it (floats
    rounded to 6 places); over ``fields`` only when given."""
    import hashlib

    h = hashlib.sha256()
    for f in out.schema.fields:
        if fields is not None and f.name not in fields:
            continue
        v, ok = out.cols[f.name]
        ok = np.asarray(ok, dtype=bool)
        h.update(f.name.encode())
        if f.type.is_string:
            src = out.dict_aliases.get(f.name, f.name)
            vals = [(x.decode("latin1") if okk else None) for x, okk in zip(
                dicts[src].decode(np.asarray(v, dtype=np.int32)), ok)]
        elif f.type.is_floating:
            vals = [(round(float(x), 6) if okk else None)
                    for x, okk in zip(np.asarray(v), ok)]
        else:
            vals = [(int(x) if okk else None)
                    for x, okk in zip(np.asarray(v), ok)]
        h.update(json.dumps(vals).encode())
    return h.hexdigest()


def golden_check(dev, use_dq=False, stats=None, fuse=False) -> list:
    """All 22 queries at the pinned (sf, seed) on the card against
    tests/golden_tpch.json, through the walk (``use_dq=False``) or the
    default routing (``use_dq=None``: the DQ stage graph for every
    join-bearing plan, which ``stats`` then checks and counts; see
    ``dq_instruments``), with whole-plan fusion pinned off; with ``fuse``,
    through ``use_dq=False`` with fusion on, every statement answered by
    a fused plan and each result also equal to the walk's. A digest that
    differs only through a float column is held against the port's CPU
    run of the same query by the same route (floats rtol 1e-12,
    everything else exact) and reported; any other difference fails.
    Returns those float-column exceptions."""
    with fusion_force(None if fuse else False):
        return _golden_check(dev, use_dq, stats, fuse)


def _golden_check(dev, use_dq, stats, fuse) -> list:
    from ydb_tpu_torch.workload import tpch
    from ydb_tpu_torch.workload.queries import TPCH

    golden = json.load(open(os.path.join(HERE, "tests", "golden_tpch.json")))
    tp = tpch.TpchData(sf=golden["sf"], seed=golden["seed"])
    db, catalog = sql_database(tp, dev)
    cpu = None
    exceptions = []
    for name, want in golden["queries"].items():
        pq = plan_sql(TPCH[name], db, catalog, use_dq)
        if fuse:
            with routed() as seen:
                res = run_sql(pq, db, use_dq)
            assert seen == ["fused"], (name, seen)
            with fusion_force(False):
                same_result(res, run_sql(pq, db, use_dq), name)
            drop_fused(db)
        elif stats is None:
            res = run_sql(pq, db, use_dq)
        else:
            with dq_instruments() as st:
                res = run_sql(pq, db, use_dq)
            assert st["executor"] == ("walk" if name in ("q1", "q6")
                                      else "dq"), (name, st["executor"])
            for k in ("hash_splits", "parked", "spill_count",
                      "multi_block_channels"):
                stats[k] = stats.get(k, 0) + st[k]
        assert res.num_rows == want["rows"], (name, res.num_rows, want)
        if golden_digest(res, tp.dicts) == want["sha"]:
            continue
        if cpu is None:
            cpu = sql_database(tp, "cpu")
        ref = run_sql(plan_sql(TPCH[name], *cpu, use_dq), cpu[0], use_dq)
        assert golden_digest(ref, tp.dicts) == want["sha"], name
        floats = [f.name for f in res.schema.fields if f.type.is_floating]
        others = [f.name for f in res.schema.fields
                  if not f.type.is_floating]
        assert golden_digest(res, tp.dicts, others) == \
            golden_digest(ref, tp.dicts, others), (name, "non-float columns")
        differ = []
        for col in floats:
            (gv, go), (cv, co) = res.cols[col], ref.cols[col]
            assert np.array_equal(go, co), (name, col, "validity")
            np.testing.assert_allclose(gv[go], cv[co], rtol=1e-12,
                                       err_msg=f"{name} {col}")
            if golden_digest(res, tp.dicts, [col]) != \
                    golden_digest(ref, tp.dicts, [col]):
                differ.append(col)
        exceptions.append({"query": name, "float_columns": differ})
        log(f"golden {name}: digest differs on the card only through float "
            f"column(s) {differ}; equal to the CPU run at rtol 1e-12")
    route = ("fused" if fuse else "walk" if use_dq is False
             else "default routing")
    log(f"SQL golden check ({route}): {len(golden['queries'])} queries at sf {golden['sf']}, seed "
        f"{golden['seed']} match tests/golden_tpch.json on the card "
        f"({len(exceptions)} float-column exceptions)")
    return exceptions


def _decoded(res, col, dicts):
    src = res.dict_aliases.get(col, col)
    return dicts[src].decode(np.asarray(res.cols[col][0], dtype=np.int32))


def _ints(res, col):
    return np.asarray(res.cols[col][0]).astype(np.int64)


def check_sql_q1(res, li, dicts, want=None):
    """Q1 against ``want`` (``numpy_q1`` of ``li``, computed when None)."""
    check_q1(res, want if want is not None
             else numpy_q1(li, tpch_days("1998-12-01") - 90))
    keys = list(zip(_decoded(res, "l_returnflag", dicts),
                    _decoded(res, "l_linestatus", dicts)))
    assert keys == sorted(keys), keys


def check_cols(res, want, dicts) -> None:
    """Each column of ``want`` equals ``res``'s: integer arrays exactly,
    lists of strings as ``res``'s decoded values."""
    for col, w in want.items():
        if isinstance(w, list):
            assert _decoded(res, col, dicts) == w, col
        else:
            assert np.array_equal(_ints(res, col), w), col


def want_sql_q3(t, dicts) -> dict:
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    d = tpch_days("1995-03-15")
    cust_ok = c["c_mktsegment"] == dicts["c_mktsegment"].eq_id(b"BUILDING")
    o_ok = (o["o_orderdate"] < d) & cust_ok[o["o_custkey"] - 1]
    oi = li["l_orderkey"] - 1
    m = (li["l_shipdate"] > d) & o_ok[oi]
    rev = np.zeros(len(o_ok), dtype=np.int64)
    np.add.at(rev, oi[m], li["l_extendedprice"][m]
              * (100 - li["l_discount"][m]))
    keys = np.unique(oi[m])
    top = keys[np.lexsort((keys, o["o_orderdate"][keys], -rev[keys]))[:10]]
    return {"l_orderkey": top + 1, "revenue": rev[top],
            "o_orderdate": o["o_orderdate"][top],
            "o_shippriority": o["o_shippriority"][top]}


def want_sql_q5(t, dicts) -> dict:
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    s, n, r = t["supplier"], t["nation"], t["region"]
    asia = r["r_regionkey"][r["r_name"] == dicts["r_name"].eq_id(b"ASIA")]
    nation_ok = np.isin(n["n_regionkey"], asia)
    o_ok = ((o["o_orderdate"] >= tpch_days("1994-01-01"))
            & (o["o_orderdate"] < tpch_days("1995-01-01")))
    oi = li["l_orderkey"] - 1
    supp_nat = s["s_nationkey"][li["l_suppkey"] - 1]
    cust_nat = c["c_nationkey"][o["o_custkey"][oi] - 1]
    m = o_ok[oi] & (cust_nat == supp_nat) & nation_ok[supp_nat]
    rev = np.zeros(len(n["n_nationkey"]), dtype=np.int64)
    np.add.at(rev, supp_nat[m], li["l_extendedprice"][m]
              * (100 - li["l_discount"][m]))
    present = np.flatnonzero(np.bincount(supp_nat[m], minlength=len(rev)))
    order = present[np.argsort(-rev[present], kind="stable")]
    return {"revenue": rev[order],
            "n_name": dicts["n_name"].decode(n["n_name"][order])}


def want_sql_q13(t, dicts) -> dict:
    import re

    o = t["orders"]
    special = np.array([re.search(b"special.*requests", v, re.S) is not None
                        for v in dicts["o_comment"].values])
    keep = ~special[o["o_comment"]]
    n_cust = len(t["customer"]["c_custkey"])
    per_cust = np.bincount(o["o_custkey"][keep] - 1, minlength=n_cust)
    dist = np.bincount(per_cust)
    counts = np.flatnonzero(dist)
    order = np.lexsort((-counts, -dist[counts]))
    return {"c_count": counts[order], "custdist": dist[counts][order]}


def want_sql_q18(t, dicts) -> dict:
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    # per-order quantity sums stay far below 2^53: exact in float64
    qty = np.bincount(li["l_orderkey"] - 1, weights=li["l_quantity"],
                      minlength=len(o["o_orderkey"])).astype(np.int64)
    big = np.flatnonzero(qty > 300_00)
    top = big[np.lexsort((big, o["o_orderdate"][big],
                          -o["o_totalprice"][big]))[:100]]
    cust = o["o_custkey"][top]
    return {"o_orderkey": top + 1, "c_custkey": cust,
            "o_orderdate": o["o_orderdate"][top],
            "o_totalprice": o["o_totalprice"][top], "total_qty": qty[top],
            "c_name": dicts["c_name"].decode(c["c_name"][cust - 1])}


def check_sql_q3(res, t, dicts, want=None):
    check_cols(res, want or want_sql_q3(t, dicts), dicts)


def check_sql_q5(res, t, dicts, want=None):
    check_cols(res, want or want_sql_q5(t, dicts), dicts)


def check_sql_q6(res, li, want=None):
    if want is None:
        want = numpy_q6(li, tpch_days("1994-01-01"),
                        tpch_days("1995-01-01"))
    assert res.num_rows == 1 and int(_ints(res, "revenue")[0]) == want


def check_sql_q13(res, t, dicts, want=None):
    check_cols(res, want or want_sql_q13(t, dicts), dicts)


def check_sql_q18(res, t, dicts, want=None):
    check_cols(res, want or want_sql_q18(t, dicts), dicts)


def layer_timers(cache):
    """Wrap the plan walk's layer entry points, and the compiled
    transforms in ``cache``, with host-clock timers, each call bracketed
    by ``torch.cuda.synchronize()``: table scans, joins, transforms and
    concats. Returns (seconds by layer, restore function)."""
    from ydb_tpu_torch.plan import executor
    from ydb_tpu_torch.ssa import join

    totals: dict = {}
    saved = {}

    def timed(layer, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            totals[layer] = totals.get(layer, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    for mod, name, layer in ((executor, "_scan_node", "scan"),
                             (executor, "_materialize", "scan"),
                             (join, "run_equi_join", "join"),
                             (executor, "concat_blocks", "concat")):
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, timed(layer, getattr(mod, name)))
    # compiled transforms are cached as (run, aux) pairs
    transforms = {k: v for k, v in cache.items() if isinstance(v, tuple)}
    for k, (run, aux) in transforms.items():
        cache[k] = (timed("transform", run), aux)

    def restore():
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
        cache.update(transforms)

    return totals, restore


def busy_share(run) -> dict:
    """One call of ``run`` under ``torch.profiler``: device busy time as
    the union of device intervals, its share of the wall time, device
    operations, the top kernels."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from profile_torch_scan import kernel_stats

    prof, wall = profiled(run)
    busy_us, ops, top = kernel_stats(prof, 3)
    return {"profiled_wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall, "device_ops": ops,
            "top_kernels": top}


def profile_sql(pq, db) -> dict:
    """Where one warm walk of a planned query spends its time: one run
    under ``torch.profiler`` (``busy_share``), then one run with the
    walk's layers timed."""
    busy = busy_share(lambda: run_sql(pq, db, False))
    totals, restore = layer_timers(db._compile_cache)
    try:
        t0 = time.perf_counter()
        run_sql(pq, db, False)
        synced = time.perf_counter() - t0
    finally:
        restore()
    return {**busy, "synced_wall_s": synced,
            "layers_s": dict(sorted(totals.items()))}


def sql_phase(tp, dev, ck, answers=None):
    """The 22 queries at the scale of ``tp`` on the card through the
    walk: per query the plan time, the first run, ``SQL_WARM`` warm runs,
    result rows, peak device memory (reset per query), the CUDA kernels'
    launches (counted from zero for the query's first run and read just
    after it), and where a warm run's time goes (``profile_sql``).
    Returns the rows, the database and catalog, the checks and each
    query's result (the DQ phase holds its results against them). A
    check's numpy answer is computed once and kept for the DQ phase's
    check of the same query; ``answers`` are phase 3's numpy Q1 and Q6 of
    the same lineitem, when the phase runs at its scale. Whole-plan
    fusion is pinned off (at sf 0.01 it would answer every
    ``use_dq=False`` statement)."""
    t = tp.tables
    for table, key in (("orders", "o_orderkey"), ("customer", "c_custkey"),
                       ("supplier", "s_suppkey")):
        # the numpy checks index these tables by key - 1
        assert np.array_equal(t[table][key],
                              np.arange(1, len(t[table][key]) + 1)), table
    t0 = time.perf_counter()
    db, catalog = sql_database(tp, dev)
    torch.cuda.synchronize()
    log(f"SQL: {len(t)} tables ({sum(len(next(iter(c.values()))) for c in t.values())} rows) "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    want1, want6 = answers or (None, None)
    wants: dict = {}

    def want(name, fn):
        if name not in wants:
            wants[name] = fn(t, tp.dicts)
        return wants[name]

    checks = {
        "q1": lambda r: check_sql_q1(r, t["lineitem"], tp.dicts, want1),
        "q3": lambda r: check_sql_q3(r, t, tp.dicts,
                                     want("q3", want_sql_q3)),
        "q5": lambda r: check_sql_q5(r, t, tp.dicts,
                                     want("q5", want_sql_q5)),
        "q6": lambda r: check_sql_q6(r, t["lineitem"], want6),
        "q13": lambda r: check_sql_q13(r, t, tp.dicts,
                                       want("q13", want_sql_q13)),
        "q18": lambda r: check_sql_q18(r, t, tp.dicts,
                                       want("q18", want_sql_q18)),
    }
    with fusion_force(False):
        rows, results = _sql_phase_queries(tp, db, catalog, checks, dev, ck)
    return rows, db, catalog, checks, results


#: warm runs of each query in phase 5, after its checked first run
SQL_WARM = 1


def _sql_phase_queries(tp, db, catalog, checks, dev, ck):
    from ydb_tpu_torch.workload.queries import TPCH

    rows, results = [], {}
    for name in sorted(TPCH, key=lambda q: int(q[1:])):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        pq = plan_sql(TPCH[name], db, catalog, False)
        plan_s = time.perf_counter() - t0
        ck.reset_launches()
        t0 = time.perf_counter()
        res = run_sql(pq, db, False)
        first_s = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        results[name] = res
        warm = []
        for _ in range(SQL_WARM):
            t0 = time.perf_counter()
            again = run_sql(pq, db, False)
            warm.append(time.perf_counter() - t0)
        assert again.num_rows == res.num_rows, name
        peak = torch.cuda.max_memory_allocated(dev)
        prof = profile_sql(pq, db)
        checked = name in checks
        if checked:
            checks[name](res)
        row = {"query": name, "sf": tp.sf, "rows": res.num_rows,
               "plan_s": plan_s, "first_s": first_s,
               "warm_median_s": statistics.median(warm), "warm_s": warm,
               "warm_spread": max(warm) / min(warm),
               "peak_device_bytes": peak, "resident_bytes": base,
               "query_peak_bytes": peak - base, "launches": launches,
               "numpy_checked": checked, **prof}
        rows.append(row)
        emit({"sql": row})
    return rows, results


# ---------------- phase 6: the DQ stage graph ----------------


#: a DQ query whose first run took longer than this gets one warm run,
#: not three, unless ``--dq-warm`` says otherwise
DQ_SLOW_FIRST_S = 2.0

#: the DQ phase's warm and profiled runs (beyond each query's first,
#: checked run) are made only while the script's clock, with them, stays
#: under this: the whole run then ends well inside its time limit
DQ_EXTRAS_BUDGET_S = 150.0

#: the DQ layers that ``dq_instruments(timed=True)`` times, by the port
#: function that does each layer's work (module or class, attribute)
DQ_LAYERS = (
    ("source_blocks", "ComputeActor", "_pump_source"),
    ("block_program", "_CompiledStage", "run_block"),
    ("payload_fetch", None, "block_to_payload"),
    ("hash", None, "_hash_rows"),
    ("split", None, "_split_by_hash"),
    ("payload_to_block", None, "payload_to_block"),
    ("payload_to_block", None, "_assemble"),
    ("join", "_CompiledStage", "run_join"),
    ("finalize", "_CompiledStage", "run_final"),
    ("spill", "Spiller", "put"),
    ("spill", "Spiller", "get"),
)


class dq_instruments:
    """Wrap the port's DQ functions for one statement, from outside the
    package: which executor answered (``_execute_plan_dq`` returned a
    block or fell back), the graph's stages and tasks, bytes fetched to
    the host (``block_to_payload``) and sent back (``payload_to_block``,
    ``_assemble``), rows hashed, channel payloads parked behind the
    credit window, channels that carried more than one block, and the
    spillers' ``spill_count``. With ``timed``, each layer of
    ``DQ_LAYERS`` is also timed on the host clock with a
    ``torch.cuda.synchronize()`` on both sides of every call; nested
    calls are charged to the inner layer only, so the layers and
    ``other`` add up to the statement's wall time."""

    def __init__(self, timed: bool = False):
        self.timed = timed

    def __enter__(self) -> dict:
        from ydb_tpu_torch.dq import compute, spilling
        from ydb_tpu_torch.plan import executor

        st = self.stats = {
            "executor": "walk", "stages": 0, "tasks": 0,
            "bytes_to_host": 0, "bytes_to_device": 0, "rows_hashed": 0,
            "hash_splits": 0, "parked": 0, "spill_count": 0,
            "multi_block_channels": 0, "layers_s": {}}
        self.handles = []
        owners = {None: compute, "ComputeActor": compute.ComputeActor,
                  "_CompiledStage": compute._CompiledStage,
                  "Spiller": spilling.Spiller}
        self.saved = []
        stack: list = []
        timed = self.timed

        def patch(owner, name, wrapper):
            real = getattr(owner, name)
            self.saved.append((owner, name, real))
            setattr(owner, name, wrapper(real))

        def layer(name, count=None):
            def wrapper(real):
                def call(*a, **k):
                    if timed:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        stack.append(0.0)
                    try:
                        out = real(*a, **k)
                    finally:
                        if timed:
                            torch.cuda.synchronize()
                            took = time.perf_counter() - t0
                            inner = stack.pop()
                            ls = st["layers_s"]
                            ls[name] = ls.get(name, 0.0) + took - inner
                            if stack:
                                stack[-1] += took
                    if count is not None:
                        count(a, out)
                    return out
                return call
            return wrapper

        def nbytes(payloads):
            return sum(v.nbytes for p in payloads for v in p.values())

        def add(key, n):
            st[key] += n

        counters = {
            "block_to_payload": lambda a, out: add("bytes_to_host",
                                                   nbytes([out])),
            "payload_to_block": lambda a, out: add("bytes_to_device",
                                                   nbytes([a[0]])),
            "_assemble": lambda a, out: add("bytes_to_device",
                                            nbytes(a[0])),
            "_hash_rows": lambda a, out: add("rows_hashed", len(out)),
            "_split_by_hash": lambda a, out: add("hash_splits",
                                                 int(a[2] > 1)),
        }
        for lname, owner, name in DQ_LAYERS:
            patch(owners[owner], name, layer(lname, counters.get(name)))

        def send(real):
            def call(actor, ch, payload):
                if actor._unacked[ch] >= actor.window:
                    st["parked"] += 1
                return real(actor, ch, payload)
            return call

        def build(real):
            def call(*a, **k):
                handle = real(*a, **k)
                self.handles.append(handle)
                return handle
            return call

        def answered(real):
            def call(plan, db):
                out = real(plan, db)
                if out is not None:
                    st["executor"] = "dq"
                return out
            return call

        patch(compute.ComputeActor, "_send_channel", send)
        patch(compute, "build_stage_graph", build)
        patch(executor, "_execute_plan_dq", answered)
        self.t0 = time.perf_counter()
        return st

    def __exit__(self, *exc):
        wall = time.perf_counter() - self.t0
        for owner, name, real in reversed(self.saved):
            setattr(owner, name, real)
        st = self.stats
        for h in self.handles:
            st["stages"] += len({t.stage for t in h.tasks})
            st["tasks"] += len(h.tasks)
            for a in h.actors:
                st["spill_count"] += a.spiller.spill_count
                # every channel's last seq is its finish message
                st["multi_block_channels"] += sum(
                    n > 2 for n in a._next_seq.values())
        if self.timed:
            st["layers_s"] = dict(sorted(st["layers_s"].items()))
            st["wall_s"] = wall
            st["layers_s"]["other"] = wall - sum(st["layers_s"].values())
        return False


def dq_golden_check(dev) -> dict:
    """The 22 queries at sf 0.01, seed 11 through the default routing
    against tests/golden_tpch.json: once with the reference's DQ defaults
    (2 tasks, 1<<20-row blocks), once with 3 tasks and 1<<12-row blocks
    (hash splits, parked channel payloads and multi-block channels then
    happen on the card, and are counted)."""
    from ydb_tpu_torch.plan import executor

    out = {}
    saved = executor.DQ_TASKS, executor.DQ_BLOCK_ROWS
    for tasks, rows in ((2, 1 << 20), (3, 1 << 12)):
        executor.DQ_TASKS, executor.DQ_BLOCK_ROWS = tasks, rows
        stats: dict = {}
        try:
            exc = golden_check(dev, use_dq=None, stats=stats)
        finally:
            executor.DQ_TASKS, executor.DQ_BLOCK_ROWS = saved
        key = f"tasks{tasks}_rows{rows}"
        out[key] = {"float_exceptions": exc, **stats}
        log(f"DQ golden check, {tasks} tasks, {rows}-row blocks: 20 "
            f"join-bearing queries answered by the DQ stage graph, q1/q6 "
            f"by the walk; {json.dumps(stats)}")
    return out


def same_result(got, want, name) -> None:
    """``got`` equals ``want``: the same columns and rows in the same
    order, validity, integers and dictionary ids exact, float64 within
    rtol 1e-12 (partial sums merge in another order)."""
    assert list(got.schema.names) == list(want.schema.names), name
    assert got.num_rows == want.num_rows, (name, got.num_rows, want.num_rows)
    for col in want.schema.names:
        (gv, go), (wv, wo) = got.cols[col], want.cols[col]
        assert np.array_equal(go, wo), (name, col, "validity")
        assert gv.dtype == wv.dtype, (name, col, gv.dtype, wv.dtype)
        if np.issubdtype(wv.dtype, np.floating):
            np.testing.assert_allclose(gv[wo], wv[wo], rtol=1e-12,
                                       err_msg=f"{name} {col}")
        else:
            assert np.array_equal(gv[wo], wv[wo]), (name, col)


def dq_phase(tp, db, catalog, dev, ck, walk, checks, n_warm=None) -> list:
    """The 22 queries at the scale of ``tp`` through the default routing
    (the DQ stage graph for the 20 join-bearing ones, at the reference's
    2 tasks and 1<<20-row blocks), over the tables ``db`` holds on the
    card. Per query, always: which executor answered, stages and tasks,
    plan seconds, the first run (CUDA kernel launches counted from zero
    for it and read just after; channel bytes, rows hashed, parked
    payloads and spills counted in it), peak device memory above the
    resident tables in it, and the checks: the result must equal the
    walk's (``walk``) and pass the numpy check of its query in
    ``checks``; a join-bearing query the walk answered fails the run.
    Then, while the script's clock stays under ``DQ_EXTRAS_BUDGET_S``:
    warm runs (three, or one where the first run took over
    ``DQ_SLOW_FIRST_S``) and one more warm run under ``torch.profiler``
    with the DQ layers timed (``dq_instruments``: the device busy share
    of its wall time, and the seconds per layer); their fields are null
    for a query past the budget. ``n_warm`` forces that many warm runs
    and the profiled run for every query, budget or not."""
    from ydb_tpu_torch.workload.queries import TPCH

    rows = []
    for name in sorted(TPCH, key=lambda q: int(q[1:])):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        pq = plan_sql(TPCH[name], db, catalog)
        plan_s = time.perf_counter() - t0
        ck.reset_launches()
        with dq_instruments() as counts:
            t0 = time.perf_counter()
            res = run_sql(pq, db)
            first_s = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        assert counts["executor"] == ("walk" if name in ("q1", "q6")
                                      else "dq"), (name, counts)
        same_result(res, walk[name], name)
        if name in checks:
            checks[name](res)
        row = {"query": name, "sf": tp.sf, "executor": counts["executor"],
               "stages": counts["stages"], "tasks": counts["tasks"],
               "rows": res.num_rows, "plan_s": plan_s, "first_s": first_s,
               "warm_median_s": None, "warm_s": [], "warm_spread": None,
               "peak_device_bytes": peak, "resident_bytes": base,
               "query_peak_bytes": peak - base,
               "bytes_to_host": counts["bytes_to_host"],
               "bytes_to_device": counts["bytes_to_device"],
               "rows_hashed": counts["rows_hashed"],
               "hash_splits": counts["hash_splits"],
               "parked": counts["parked"],
               "spill_count": counts["spill_count"],
               "launches": launches, "equals_walk": True,
               "numpy_checked": name in checks, "device_busy_share": None,
               "layers_s": None}
        runs = n_warm or (1 if first_s > DQ_SLOW_FIRST_S else 3)
        if n_warm or (time.perf_counter() - STARTED + (runs + 1) * first_s
                      <= DQ_EXTRAS_BUDGET_S):
            warm = []
            for _ in range(runs):
                t0 = time.perf_counter()
                again = run_sql(pq, db)
                warm.append(time.perf_counter() - t0)
                assert again.num_rows == res.num_rows, name
            layered: dict = {}

            def timed_run():
                with dq_instruments(timed=True) as st:
                    run_sql(pq, db)
                layered.update(st)

            row.update(warm_median_s=statistics.median(warm), warm_s=warm,
                       warm_spread=max(warm) / min(warm),
                       **busy_share(timed_run),
                       synced_wall_s=layered["wall_s"],
                       layers_s=layered["layers_s"])
        rows.append(row)
        emit({"sql_dq": row})
    return rows


# ---------------- phase 7: whole-plan fusion ----------------


#: TPC-H scale of the fused measurement: lineitem then has 120,088 rows,
#: the largest scale whose tables all stay under plan_fuse.FUSE_MAX_ROWS
FUSION_SF = 0.02
#: ClickBench hits rows of the fused measurement: FUSE_MAX_ROWS itself
FUSION_HITS_ROWS = 1 << 17
#: warm runs per statement and path
FUSION_WARM = 3
#: the cutoff sweep: rows of lineitem / hits, and the TPC-H scale that
#: gives about that many lineitem rows (the 131K point reuses FUSION_SF)
SWEEP_POINTS = ((16384, 0.0027), (65536, 0.0109), (131072, FUSION_SF),
                (1 << 20, 0.1667))
SWEEP_QUERIES = ("q1", "q3", "q6", "cb_q33")


class fusion_force:
    """``plan_fuse.FUSE_FORCE = force`` for a block, restored after."""

    def __init__(self, force):
        self.force = force

    def __enter__(self):
        from ydb_tpu_torch.ssa import plan_fuse

        self.saved = plan_fuse.FUSE_FORCE
        plan_fuse.FUSE_FORCE = self.force

    def __exit__(self, *exc):
        from ydb_tpu_torch.ssa import plan_fuse

        plan_fuse.FUSE_FORCE = self.saved
        return False


class routed:
    """Record which executor answered each statement in the block
    ("fused", "dq"; "walk" when neither did), by wrapping the executor's
    two entry points from outside the package."""

    def __enter__(self) -> list:
        from ydb_tpu_torch.plan import executor

        self.seen: list = []
        self.saved = {}
        for name in ("_execute_plan_fused", "_execute_plan_dq"):
            real = self.saved[name] = getattr(executor, name)

            def call(plan, db, _real=real, _kind=name.rsplit("_", 1)[-1]):
                out = _real(plan, db)
                if out is not None:
                    self.seen.append(_kind)
                return out

            setattr(executor, name, call)
        return self.seen

    def __exit__(self, *exc):
        from ydb_tpu_torch.plan import executor

        for name, real in self.saved.items():
            setattr(executor, name, real)
        return False


def fused_plans(db) -> list:
    """The FusedPlans cached in ``db``."""
    return [v for k, v in db._compile_cache.items()
            if isinstance(k, tuple) and k and k[0] == "plan_fuse"]


def drop_fused(db) -> None:
    """Free every cached FusedPlan of ``db`` with its graphs and pools."""
    for k in [k for k in db._compile_cache
              if isinstance(k, tuple) and k and k[0] == "plan_fuse"]:
        for cap in db._compile_cache.pop(k)._graphs.values():
            cap.graph.reset()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def timed_runs(fn, n: int) -> list:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def fused_statement(name, pq, db, ck, dev) -> tuple:
    """One statement (planned, ``pq``) through the fused path
    (``use_dq=False``, fusion on) and through the walk over ``db``: the
    fused first run (a capture) with the CUDA kernels' launches counted
    from zero, ``FUSION_WARM`` warm runs of each path, one more fused run
    under ``torch.profiler``. The fused result must equal the walk's.
    Returns (row, fused result, walk result)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = set(map(id, fused_plans(db)))
    with fusion_force(None), routed() as seen:
        ck.reset_launches()
        t0 = time.perf_counter()
        res = run_sql(pq, db, False)
        first_s = time.perf_counter() - t0
        first_launches = dict(ck.LAUNCHES)
        executor = seen[-1] if seen else "walk"
        plans = [p for p in fused_plans(db) if id(p) not in before]
        r0 = sum(p.replays for p in plans)
        c0 = sum(p.captures for p in plans)
        ck.reset_launches()
        seen.clear()
        warm = timed_runs(lambda: run_sql(pq, db, False), FUSION_WARM)
        warm_launches = {k: v / FUSION_WARM for k, v in ck.LAUNCHES.items()}
        assert seen == ["fused"] * FUSION_WARM, (name, seen)
        replays = (sum(p.replays for p in plans) - r0) / FUSION_WARM
        captures = sum(p.captures for p in plans) - c0
        prof = busy_share(lambda: run_sql(pq, db, False))
    peak = torch.cuda.max_memory_allocated(dev)
    with fusion_force(False):
        t0 = time.perf_counter()
        walk = run_sql(pq, db, False)
        walk_first_s = time.perf_counter() - t0
        walk_warm = timed_runs(lambda: run_sql(pq, db, False), FUSION_WARM)
    same_result(res, walk, name)
    fused_med = statistics.median(warm)
    walk_med = statistics.median(walk_warm)
    row = {"query": name, "executor": executor,
           "fused_stages": sum(p.fused_stages for p in plans),
           "plans": len(plans), "rows": res.num_rows,
           "first_s": first_s,
           "capture_s": sum(p.capture_seconds or 0.0 for p in plans),
           "first_trace_s": sum(p.first_trace_seconds or 0.0 for p in plans),
           "warm_median_s": fused_med, "warm_s": warm,
           "walk_first_s": walk_first_s, "walk_warm_median_s": walk_med,
           "walk_warm_s": walk_warm, "walk_over_fused": walk_med / fused_med,
           "replays_per_warm": replays, "captures_in_warm": captures,
           "grows": sum(p.grows for p in plans),
           "kernel_launches_first": first_launches,
           "kernel_launches_per_warm": warm_launches,
           "device_ops_per_warm": prof["device_ops"],
           "device_busy_share": prof["device_busy_share"],
           "profiled_wall_s": prof["profiled_wall_s"],
           "top_kernels": prof["top_kernels"],
           "peak_device_bytes": peak, "resident_bytes": base,
           "query_peak_bytes": peak - base,
           "pool_bytes": sum(p.pool_bytes or 0 for p in plans),
           "equals_walk": True}
    assert executor == "fused", (name, executor)
    assert replays == 1 and captures == 0, (name, replays, captures)
    return row, res, walk


def fusion_golden_check(dev) -> list:
    """The 22 queries at the goldens' (sf, seed) through
    ``execute_plan(..., use_dq=False)`` with fusion on: every statement
    answered by a fused plan, each equal to its golden and to the walk."""
    exceptions = golden_check(dev, use_dq=False, fuse=True)
    log(f"fusion golden check: 22 queries fused on the card, each equal to "
        f"the walk; {len(exceptions)} float-column exceptions")
    return exceptions


def clickbench_database(cb, dev):
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.plan import Database
    from ydb_tpu_torch.sql.planner import Catalog
    from ydb_tpu_torch.workload import clickbench

    db = Database(
        sources={"hits": ColumnSource(cb.hits, clickbench.HITS_SCHEMA,
                                      cb.dicts).to_device(dev)},
        dicts=cb.dicts, device=dev)
    catalog = Catalog(schemas={"hits": clickbench.HITS_SCHEMA},
                      primary_keys={"hits": ("WatchID",)}, dicts=cb.dicts)
    return db, catalog


def member_inputs(sig, db, dev) -> dict:
    """A dispatch's staged inputs for ``sig`` from ``db``'s tables, as
    fresh blocks (the serving tier's staged members)."""
    from ydb_tpu_torch.blocks.block import TableBlock

    out = {}
    for s in sig.sites:
        src = db.sources[s.table]
        out[s.key] = TableBlock.from_numpy(
            {m: src.columns[m] for m in s.read_cols}, s.in_schema, None,
            capacity=s.capacity, device=dev)
    return out


def stacked_check(cases, dev) -> list:
    """``run_shared`` and ``run_stacked`` at B = 4 for each (name, plan,
    member databases): each member's slice of one stacked replay equals
    that member's serial run, and the members' answers differ."""
    from ydb_tpu_torch.plan import to_host
    from ydb_tpu_torch.ssa import plan_fuse

    rows = []
    for name, plan, dbs in cases:
        sig = plan_fuse.plan_signature(plan, dbs[0])
        fused = plan_fuse.build(sig, dbs[0])
        members = [member_inputs(sig, d, dev) for d in dbs]
        serial = [to_host(fused.run_shared(m)[0]) for m in members]
        out, _ = fused.run_stacked(members)
        again, _ = fused.run_stacked(members)
        for i, want in enumerate(serial):
            same_result(to_host(plan_fuse.slice_member(out, i)), want, name)
            same_result(to_host(plan_fuse.slice_member(again, i)), want,
                        name)
        distinct = len({json.dumps([np.asarray(v).tolist()
                                    for v, _ in r.cols.values()])
                        for r in serial})
        assert distinct > 1, name
        rows.append({"query": name, "batch": len(members),
                     "replays": fused.replays, "captures": fused.captures,
                     "pool_bytes": fused.pool_bytes,
                     "distinct_member_results": distinct})
        for cap in fused._graphs.values():
            cap.graph.reset()
    log("run_shared / run_stacked at B = 4: every member's slice equals its "
        f"serial run: {json.dumps(rows)}")
    return rows


def sweep_point(name, pq, db, label) -> dict:
    """Warm medians of one planned statement, fused and walked."""
    with fusion_force(None), routed() as seen:
        t0 = time.perf_counter()
        res = run_sql(pq, db, False)
        first_s = time.perf_counter() - t0
        assert seen == ["fused"], (label, seen)
        fused = statistics.median(timed_runs(
            lambda: run_sql(pq, db, False), FUSION_WARM))
    with fusion_force(False):
        walk_res = run_sql(pq, db, False)
        walk = statistics.median(timed_runs(
            lambda: run_sql(pq, db, False), FUSION_WARM))
    same_result(res, walk_res, label)
    drop_fused(db)
    return {"query": name, "fused_first_s": first_s,
            "fused_warm_median_s": fused, "walk_warm_median_s": walk,
            "walk_over_fused": walk / fused}


def fusion_phase(dev, ck, sweep=True) -> dict:
    """Phase 7: whole-plan fusion at the fused path's full size (see the
    module docstring). Returns the rows of each sub-phase."""
    from ydb_tpu_torch.plan.nodes import TableScan, Transform
    from ydb_tpu_torch.ssa import kernels, plan_fuse
    from ydb_tpu_torch.workload import clickbench, tpch
    from ydb_tpu_torch.workload.queries import TPCH

    t_phase = time.perf_counter()
    out: dict = {}
    out["golden_float_exceptions"] = fusion_golden_check(dev)

    # 2. TPC-H at FUSION_SF, tables on the card
    tp = tpch.TpchData(sf=FUSION_SF, seed=42)
    n_li = len(tp.tables["lineitem"]["l_orderkey"])
    assert n_li <= plan_fuse.FUSE_MAX_ROWS, n_li
    db, catalog = sql_database(tp, dev)
    ck.reset_launches()
    counted = {k: 0 for k in ck.LAUNCHES}

    def count(row):
        for k, v in row["kernel_launches_first"].items():
            counted[k] += v
        for k, v in row["kernel_launches_per_warm"].items():
            counted[k] += round(v * FUSION_WARM)

    tpch_rows = []
    for name in sorted(TPCH, key=lambda q: int(q[1:])):
        with fusion_force(None):
            pq = plan_sql(TPCH[name], db, catalog, False)
        row, _, _ = fused_statement(name, pq, db, ck, dev)
        row["sf"] = FUSION_SF
        count(row)
        tpch_rows.append(row)
        emit({"fused": row})
        drop_fused(db)
    out["tpch"] = tpch_rows
    log(f"fused TPC-H sf {FUSION_SF} ({n_li} lineitem rows): 22 queries, "
        f"one graph replay per warm statement, each equal to the walk; "
        f"warm medians fused / walk summed "
        f"{sum(r['warm_median_s'] for r in tpch_rows):.4f} / "
        f"{sum(r['walk_warm_median_s'] for r in tpch_rows):.4f} s")

    # 3. ClickBench at FUSION_HITS_ROWS: all 43 through the default routing
    cb = clickbench.ClickBenchData(rows=FUSION_HITS_ROWS, seed=42)
    cdb, ccat = clickbench_database(cb, dev)
    want = clickbench.reference_answers(cb)
    from ydb_tpu_torch.sql.parser import parse
    from ydb_tpu_torch.sql.planner import plan_select_full

    cb_rows = []
    for name in sorted(clickbench.QUERIES, key=lambda q: int(q[1:])):
        pq = plan_select_full(parse(clickbench.QUERIES[name]), ccat)
        row, res, _ = fused_statement(f"cb_{name}", pq, cdb, ck, dev)
        clickbench._verify(name, res, want[name], cb, pq)
        with fusion_force(None), routed() as seen:
            routed_res = run_sql(pq, cdb)
        default = seen[-1]
        clickbench._verify(name, routed_res, want[name], cb, pq)
        same_result(routed_res, res, name)
        row.update(query=name, hits_rows=FUSION_HITS_ROWS,
                   default_executor=default, canondata_checked=True)
        count(row)
        cb_rows.append(row)
        emit({"clickbench": row})
        drop_fused(cdb)
    out["clickbench"] = cb_rows
    routes = collections.Counter(r["default_executor"] for r in cb_rows)
    log(f"fused ClickBench at {FUSION_HITS_ROWS} rows: 43 queries equal "
        f"reference_answers and the walk; default routing {dict(routes)}; "
        f"warm medians fused / walk summed "
        f"{sum(r['warm_median_s'] for r in cb_rows):.4f} / "
        f"{sum(r['walk_warm_median_s'] for r in cb_rows):.4f} s")

    # the per-aggregate group-by lowering (grouped_sum) inside graphs
    peragg = []
    kernels.FUSED_FORCE = False
    try:
        for name in ("q33", "q36"):
            pq = plan_select_full(parse(clickbench.QUERIES[name]), ccat)
            row, res, _ = fused_statement(f"cb_{name}_peragg", pq, cdb, ck,
                                          dev)
            clickbench._verify(name, res, want[name], cb, pq)
            count(row)
            peragg.append(row)
            emit({"clickbench_peragg": row})
            drop_fused(cdb)
    finally:
        kernels.FUSED_FORCE = None
    out["clickbench_peragg"] = peragg
    out["kernel_launches"] = counted
    log(f"CUDA kernel launches on the fused path (graph replays): {counted}")
    assert all(v > 0 for v in counted.values()), counted

    # 4. run_shared / run_stacked at B = 4
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.plan import Database

    li = tp.tables["lineitem"]
    li_dbs = []
    for i in range(4):
        cols = dict(li)
        cols["l_quantity"] = li["l_quantity"] // (i + 1)
        cols["l_discount"] = np.roll(li["l_discount"], i)
        li_dbs.append(Database(
            sources={"lineitem": ColumnSource(cols, tpch.LINEITEM_SCHEMA,
                                              tp.dicts)},
            dicts=tp.dicts, device=dev))
    n_urls = len(cb.dicts["URL"])
    hits_dbs = []
    for i in range(4):
        # the same table with its URL ids shifted: other answers, the
        # same dictionary
        cols = dict(cb.hits)
        cols["URL"] = ((cb.hits["URL"] + 37 * i) % n_urls).astype(np.int32)
        hits_dbs.append(Database(
            sources={"hits": ColumnSource(cols, clickbench.HITS_SCHEMA,
                                          cb.dicts)},
            dicts=cb.dicts, device=dev))
    q33 = plan_select_full(parse(clickbench.QUERIES["q33"]), ccat).plan
    out["stacked"] = stacked_check([
        ("q1", Transform(TableScan("lineitem"), tpch.q1_program()), li_dbs),
        ("q6", Transform(TableScan("lineitem"), tpch.q6_program()), li_dbs),
        ("cb_q33", q33, hits_dbs)], dev)
    del hits_dbs, li_dbs

    # 5. the cutoff sweep (a measurement; the default does not change)
    if sweep:
        out["sweep"] = cutoff_sweep(dev, tp, cb)
    del db, cdb
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"fusion phase: {out['seconds']:.1f} s")
    return out


def cutoff_sweep(dev, tp, cb) -> list:
    """TPC-H q1, q3, q6 and ClickBench q33, fused and walked at each of
    SWEEP_POINTS (rows of lineitem / hits); above FUSE_MAX_ROWS with the
    cutoff raised in-process for that point only."""
    from ydb_tpu_torch.sql.parser import parse
    from ydb_tpu_torch.sql.planner import plan_select_full
    from ydb_tpu_torch.ssa import plan_fuse
    from ydb_tpu_torch.workload import clickbench, tpch
    from ydb_tpu_torch.workload.queries import TPCH

    rows = []
    for hits_rows, sf in SWEEP_POINTS:
        t = tp if sf == FUSION_SF else tpch.TpchData(sf=sf, seed=42)
        c = (cb if hits_rows == FUSION_HITS_ROWS
             else clickbench.ClickBenchData(rows=hits_rows, seed=42))
        saved = plan_fuse.FUSE_MAX_ROWS
        plan_fuse.FUSE_MAX_ROWS = max(saved, 1 << 21)
        try:
            db, catalog = sql_database(t, dev)
            cdb, ccat = clickbench_database(c, dev)
            n_li = len(t.tables["lineitem"]["l_orderkey"])
            for q in SWEEP_QUERIES:
                if q.startswith("cb_"):
                    pq = plan_select_full(
                        parse(clickbench.QUERIES[q[3:]]), ccat)
                    r = sweep_point(q, pq, cdb, f"{q}@{hits_rows}")
                    r["rows"] = hits_rows
                else:
                    pq = plan_sql(TPCH[q], db, catalog, False)
                    r = sweep_point(q, pq, db, f"{q}@{sf}")
                    r.update(rows=n_li, sf=sf)
                r["above_cutoff"] = r["rows"] > saved
                rows.append(r)
                emit({"sweep_fusion": r})
            del db, cdb
            torch.cuda.empty_cache()
        finally:
            plan_fuse.FUSE_MAX_ROWS = saved
    return rows


# ---------------- phase 8: TPC-DS ----------------


#: TPC-DS scale and seed of phase 8 (the CPU tests' seed, at the scale
#: whose numpy answers take seconds)
TPCDS_SF = 0.1
TPCDS_SEED = 7


def tpcds_phase(dev, ck, sf: float = TPCDS_SF) -> list:
    """Phase 8: the 70 TPC-DS queries at ``sf``, every table on the card,
    through the default routing and through the walk (``use_dq=False``,
    fusion pinned off). Each result must equal the numpy answers
    (``verify_result``) and the walk's; one ``{"tpcds": ...}`` line per
    query."""
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.plan import Database
    from ydb_tpu_torch.sql.planner import Catalog
    from ydb_tpu_torch.workload import tpcds

    t_phase = time.perf_counter()
    data = tpcds.TpcdsData(sf=sf, seed=TPCDS_SEED)
    names = sorted(tpcds.QUERIES, key=lambda q: int(q[1:]))
    t0 = time.perf_counter()
    want = tpcds.reference_answers(data, names)
    answers_s = time.perf_counter() - t0
    db = Database(
        sources={t: ColumnSource(c, tpcds.SCHEMAS[t], data.dicts)
                 .to_device(dev) for t, c in data.tables.items()},
        dicts=data.dicts, device=dev)
    catalog = Catalog(schemas=dict(tpcds.SCHEMAS),
                      primary_keys=dict(tpcds.PRIMARY_KEYS),
                      dicts=data.dicts)
    log(f"TPC-DS sf {sf} seed {TPCDS_SEED}: "
        f"{sum(len(next(iter(c.values()))) for c in data.tables.values())} "
        f"rows in {len(data.tables)} tables on the card; numpy answers "
        f"{answers_s:.1f} s")
    rows = []
    for name in names:
        sql = tpcds.QUERIES[name]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        pq = plan_sql(sql, db, catalog)
        ck.reset_launches()
        with routed() as seen:
            t0 = time.perf_counter()
            res = run_sql(pq, db)
            first_s = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        tpcds.verify_result(name, res, want[name], data, pq)
        with fusion_force(False):
            wpq = plan_sql(sql, db, catalog, use_dq=False)
            with routed() as wseen:
                t0 = time.perf_counter()
                walk = run_sql(wpq, db, False)
                walk_first_s = time.perf_counter() - t0
        assert not wseen, (name, wseen)
        tpcds.verify_result(name, walk, want[name], data, wpq)
        same_result(res, walk, name)
        row = {"query": name, "sf": sf,
               "executor": seen[-1] if seen else "walk",
               "rows": res.num_rows, "first_s": first_s,
               "walk_first_s": walk_first_s,
               "peak_device_bytes": peak, "tables_bytes": base,
               "query_peak_bytes": peak - base, "launches": launches,
               "equals_numpy": True, "equals_walk": True}
        rows.append(row)
        emit({"tpcds": row})
    drop_fused(db)
    del db
    torch.cuda.empty_cache()
    by = collections.Counter(r["executor"] for r in rows)
    log(f"TPC-DS: {len(rows)} queries equal the numpy answers and the "
        f"walk; executors {dict(by)}; first runs summed "
        f"{sum(r['first_s'] for r in rows):.2f} s, walk "
        f"{sum(r['walk_first_s'] for r in rows):.2f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------- phase 9: the ColumnShard storage path ----------------


#: rows per ``ColumnShard.write``/``commit`` of phase 9's ingest
INGEST_CHUNK_ROWS = 1 << 20
#: portion chunk and scan block rows of phase 9's shards
#: (``bench.py:run_ooc``'s ShardConfig)
STORAGE_BLOCK_ROWS = 1 << 18
#: TPC-H scale of phase 9's sharded SQL
STORAGE_SQL_SF = 0.1


def storage_config():
    """``bench.py:run_ooc``'s ShardConfig: compaction off, 1<<18-row
    portion chunks and scan blocks."""
    from ydb_tpu_torch.engine.shard import ShardConfig

    return ShardConfig(compact_portion_threshold=10 ** 9,
                       scan_block_rows=STORAGE_BLOCK_ROWS,
                       portion_chunk_rows=STORAGE_BLOCK_ROWS)


def ingest(shard, cols) -> dict:
    """``cols`` into ``shard`` in ``INGEST_CHUNK_ROWS``-row write/commit
    pairs; rows/s and bytes on disk."""
    n = len(next(iter(cols.values())))
    t0 = time.perf_counter()
    for lo in range(0, n, INGEST_CHUNK_ROWS):
        wid = shard.write({k: v[lo:lo + INGEST_CHUNK_ROWS]
                           for k, v in cols.items()})
        shard.commit([wid])
    seconds = time.perf_counter() - t0
    shard.resident.drain(timeout=300)
    stored = sum(shard.store.size(m.blob_id)
                 for m in shard.visible_portions())
    return {"rows": n, "seconds": seconds, "rows_per_s": n / seconds,
            "portions": len(shard.visible_portions()),
            "bytes_on_disk": stored}


def fill_resident(shard) -> float:
    """Promote every visible portion from the blob store, as the eager
    write path and the heat path do (``promote_async``, at most
    ``MAX_INFLIGHT`` at a time); the budget evicts the coldest. Seconds
    taken."""
    from ydb_tpu_torch.engine.resident import portion_loader

    res = shard.resident
    assert res.enabled(), "the resident tier is off"
    t0 = time.perf_counter()
    for m in shard.visible_portions():
        while not res.promote_async(m.portion_id, m.num_rows,
                                    portion_loader(shard, m)):
            res.drain(timeout=300)
    res.drain(timeout=300)
    return time.perf_counter() - t0


class toggles:
    """Statistics, morsel pipeline and resident tier forced for a block
    (None leaves a knob to the environment), restored after."""

    def __init__(self, stats=None, pipeline=None, resident=None):
        self.want = {"stats": stats, "pipeline": pipeline,
                     "resident": resident}

    def _mods(self):
        from ydb_tpu_torch import stats
        from ydb_tpu_torch.engine import resident, stream_sched

        return {"stats": (stats, "STATS_FORCE"),
                "pipeline": (stream_sched, "PIPELINE_FORCE"),
                "resident": (resident, "RESIDENT_FORCE")}

    def __enter__(self):
        self.saved = {}
        for k, (mod, attr) in self._mods().items():
            self.saved[k] = getattr(mod, attr)
            setattr(mod, attr, self.want[k])

    def __exit__(self, *exc):
        for k, (mod, attr) in self._mods().items():
            setattr(mod, attr, self.saved[k])
        return False


def identical(got, want, what) -> None:
    """Bit for bit: names, rows, validity and every value (floats too)."""
    assert list(got.schema.names) == list(want.schema.names), what
    assert got.num_rows == want.num_rows, what
    for col in want.schema.names:
        (gv, go), (wv, wo) = got.cols[col], want.cols[col]
        assert np.array_equal(go, wo), (what, col, "validity")
        assert gv.dtype == wv.dtype and \
            np.asarray(gv)[wo].tobytes() == np.asarray(wv)[wo].tobytes(), \
            (what, col)


def shard_scan(shard, program, n_rows, dev, label) -> tuple:
    """One synced ``shard.scan``: its result and a row of what it took.
    Promotions an earlier scan queued finish before the clock starts;
    those this scan queued (heat) are counted after it, once done."""
    shard.resident.drain(timeout=300)
    before = shard.resident.snapshot()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = shard.scan(program)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    shard.resident.drain(timeout=300)
    res = shard.resident.snapshot()
    row = {"mode": label, "seconds": seconds, "rows_per_s": n_rows / seconds,
           "stages_s": shard.last_scan_stages,
           "pruning": shard.last_scan_pruning,
           "resident_portions": shard.last_scan_resident["portions"],
           "resident_rows": shard.last_scan_resident["rows"],
           "resident_share": shard.last_scan_resident["rows"] / max(n_rows,
                                                                     1),
           "resident_bytes": res["bytes"],
           "promotions_queued": res["promotions"] - before["promotions"],
           "evictions": res["evictions"] - before["evictions"],
           "pipeline": shard.last_scan_pipeline,
           "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
           "group_layout": list(
               shard.last_scan_executor.partial.group_layout)}
    return out, row


def checked_kernel_calls(ck, run) -> dict:
    """``run()`` with both kernel wrappers spied on; after it, every
    call's result is held against the plain version on the same inputs
    (int32 exact, float32 rtol 1e-5). Calls, their shapes and the
    largest |kernel - plain| of each kernel."""
    real = {"grouped_sum": ck.grouped_sum,
            "grouped_sum_multi": ck.grouped_sum_multi}
    plain = {"grouped_sum": ck.grouped_sum_plain,
             "grouped_sum_multi": ck.grouped_sum_multi_plain}
    calls = []

    def spy(name):
        def call(values, gid, num_groups):
            got = real[name](values, gid, num_groups)
            assert not torch.cuda.is_current_stream_capturing(), name
            calls.append((name, values.clone(), gid.clone(), num_groups,
                          got.clone()))
            return got
        return call

    for name in real:
        setattr(ck, name, spy(name))
    try:
        run()
    finally:
        for name, fn in real.items():
            setattr(ck, name, fn)
    torch.cuda.synchronize()
    out = {name: {"calls": 0, "shapes": [], "max_abs_err": 0.0}
           for name in real}
    for name, values, gid, num_groups, got in calls:
        want = plain[name](values, gid, num_groups)
        label = f"{name} {tuple(values.shape)} {values.dtype} {num_groups}"
        if values.dtype == torch.int32:
            assert torch.equal(got, want), label
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                       msg=label)
        row = out[name]
        row["calls"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], (
            got.double() - want.double()).abs().max().item())
        shape = [list(values.shape), str(values.dtype), num_groups]
        if shape not in row["shapes"]:
            row["shapes"].append(shape)
    return out


def sharded_tpch(tp, root, dev, n_shards=2):
    """Every table of ``tp`` split over ``n_shards`` ColumnShards by
    primary-key range on ``DirBlobStore(root)``, served as
    ``MultiShardStreamSource``s (as ``kqp/session.py:1428`` builds them)
    in a Database with a ``DeviceBlockCache``; and a Database over host
    ``ColumnSource``s of the same data."""
    from ydb_tpu_torch.engine.blobs import DirBlobStore
    from ydb_tpu_torch.engine.blockcache import DeviceBlockCache
    from ydb_tpu_torch.engine.reader import MultiShardStreamSource
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.engine.shard import ColumnShard
    from ydb_tpu_torch.plan import Database
    from ydb_tpu_torch.workload import tpch

    store = DirBlobStore(root)
    sources, by_table = {}, {}
    t0 = time.perf_counter()
    for t, cols in tp.tables.items():
        pk = tpch.PRIMARY_KEYS[t][0]
        keys = cols[pk]
        cuts = np.quantile(keys, np.linspace(0, 1, n_shards + 1)[1:-1])
        part = np.searchsorted(cuts, keys, side="right")
        shs = []
        for i in range(n_shards):
            sh = ColumnShard(f"{t}/{i}", tp.schema(t), store, pk_column=pk,
                             dicts=tp.dicts, config=storage_config(),
                             device=dev)
            m = part == i
            for lo in range(0, int(m.sum()), INGEST_CHUNK_ROWS):
                sel = np.flatnonzero(m)[lo:lo + INGEST_CHUNK_ROWS]
                sh.commit([sh.write({k: v[sel] for k, v in cols.items()})])
            shs.append(sh)
        by_table[t] = shs
        sources[t] = MultiShardStreamSource(shs, tp.schema(t), tp.dicts,
                                            device=dev)
    ingest_s = time.perf_counter() - t0
    for shs in by_table.values():
        for sh in shs:
            sh.resident.drain(timeout=300)
    db = Database(sources=sources, dicts=tp.dicts, device=dev,
                  block_cache=DeviceBlockCache(device=dev))
    host = Database(sources={t: ColumnSource(c, tp.schema(t), tp.dicts)
                             for t, c in tp.tables.items()},
                    dicts=tp.dicts, device=dev)
    return db, host, {"ingest_s": ingest_s,
                      "shards": sum(len(s) for s in by_table.values())}


def storage_phase(dev, ck, tp, cb, sql_sf: float = STORAGE_SQL_SF,
                  answers=None, keep_root: bool = False) -> dict:
    """Phase 9: the ColumnShard storage path (see the module docstring).
    ``tp`` holds phase 3's lineitem, ``cb`` its hits, ``answers`` phase
    3's numpy Q1 and Q6 (computed here when None). Returns every
    measurement; ``launches`` are the CUDA kernels' launches of the
    counted ``GROUP BY URL`` shard scans. With ``keep_root`` the
    directory of the lineitem and hits shards stays for phase 12
    (``out["root"]``, the caller removes it)."""
    import shutil
    import tempfile

    from ydb_tpu_torch.engine.blobs import DirBlobStore
    from ydb_tpu_torch.engine.shard import ColumnShard
    from ydb_tpu_torch.ssa import kernels
    from ydb_tpu_torch.ssa.ops import Op
    from ydb_tpu_torch.ssa.program import Call, Col, FilterStep, Program, lit
    from ydb_tpu_torch.workload import clickbench, tpch

    t_phase = time.perf_counter()
    out: dict = {}
    li = tp.tables["lineitem"]
    n_li = len(li["l_orderkey"])
    cutoff = tpch_days("1998-12-01") - 90
    d0, d1 = tpch_days("1994-01-01"), tpch_days("1995-01-01")
    want1, want6 = answers or (numpy_q1(li, cutoff), numpy_q6(li, d0, d1))
    q1, q6 = tpch.q1_program(), tpch.q6_program()
    tmp = tempfile.mkdtemp(prefix="ydb_tpu_torch_storage_")
    try:
        # 1. ingest SF-10 lineitem
        shard = ColumnShard("li", tpch.LINEITEM_SCHEMA, DirBlobStore(tmp),
                            dicts=tp.dicts, config=storage_config(),
                            device=dev)
        out["ingest"] = ingest(shard, li)
        out["ingest"]["resident_after_ingest"] = shard.resident.snapshot()
        log(f"storage: ingested {n_li} lineitem rows at "
            f"{out['ingest']['rows_per_s']:.0f} rows/s, "
            f"{out['ingest']['portions']} portions, "
            f"{out['ingest']['bytes_on_disk']} bytes on disk")

        # 2. Q1/Q6 in every mode, each bit-identical to the others
        scans, firsts = [], {}

        def scan(name, label):
            prog, n = (q1, n_li) if name == "q1" else (q6, n_li)
            res, row = shard_scan(shard, prog, n, dev, label)
            row["query"] = name
            if name == "q1":
                check_q1(res, want1)
            else:
                assert int(res.cols["revenue"][0][0]) == want6
            if name in firsts:
                identical(res, firsts[name], f"{name} {label}")
            else:
                firsts[name] = res
            scans.append(row)
            emit({"storage_scan": row})
            return row

        for name in ("q1", "q6"):
            shard.resident.clear()
            shard.block_cache.clear()
            scan(name, "cold")
        fill_s = fill_resident(shard)
        out["resident_fill_s"] = fill_s
        out["resident_after_fill"] = shard.resident.snapshot()
        for name in ("q1", "q6"):
            scan(name, "warm")
        for label, kw in (("pipeline_off", {"pipeline": False}),
                          ("stats_off", {"stats": False}),
                          ("resident_off", {"resident": False})):
            with toggles(**kw):
                for name in ("q1", "q6"):
                    scan(name, label)
                    if label == "resident_off":
                        # a second run reads the block cache's entry
                        scan(name, label + "_cached")
        out["scans"] = scans

        # 3. a selective scan skips portions
        hi = int(li["l_orderkey"].max()) // 10
        sel_prog = Program((FilterStep(Call(Op.LT, Col("l_orderkey"),
                                            lit(hi))),) + tuple(q6.steps))
        res, row = shard_scan(shard, sel_prog, n_li, dev, "selective")
        m = li["l_orderkey"] < hi
        want = numpy_q6({k: v[m] for k, v in li.items()}, d0, d1)
        assert int(res.cols["revenue"][0][0]) == want
        assert row["pruning"]["portions_skipped"] > 0, row["pruning"]
        out["selective"] = row
        emit({"storage_scan": row})

        # 4. reboot from the blob store alone: every write reads back
        t0 = time.perf_counter()
        booted = ColumnShard.boot("li", tpch.LINEITEM_SCHEMA,
                                  DirBlobStore(tmp), config=storage_config(),
                                  device=dev)
        boot_s = time.perf_counter() - t0
        assert booted.snap == shard.snap
        assert [m.to_json() for m in booted.visible_portions()] == \
            [m.to_json() for m in shard.visible_portions()]
        res, row = shard_scan(booted, q6, n_li, dev, "rebooted")
        row["query"] = "q6"
        identical(res, firsts["q6"], "q6 rebooted")
        out["reboot"] = {"boot_s": boot_s, **row}
        emit({"storage_scan": out["reboot"]})
        del shard, booted
        torch.cuda.empty_cache()

        # 5. ClickBench hits: GROUP BY URL through shard.scan, counted
        hits = ColumnShard("hits", clickbench.HITS_SCHEMA,
                           DirBlobStore(tmp), dicts=cb.dicts,
                           config=storage_config(), device=dev)
        out["hits_ingest"] = ingest(hits, cb.hits)
        n_hits = out["hits_ingest"]["rows"]
        cb_answers = clickbench.q33_q36_answers(cb)
        progs = {"q33": clickbench.q33_program(),
                 "q36": clickbench.q36_program()}
        for name in ("q33", "q36"):  # first runs: build the executors
            hits.scan(progs[name])
        hits.resident.drain(timeout=300)
        ck.reset_launches()
        cb_rows = []
        for name, col in (("q33", "c"), ("q36", "pv")):
            for lowering, fused in (("fused", True), ("peragg", False)):
                kernels.FUSED_FORCE = fused
                try:
                    before = dict(ck.LAUNCHES)
                    res, row = shard_scan(hits, progs[name], n_hits, dev,
                                          f"{name}_{lowering}")
                finally:
                    kernels.FUSED_FORCE = None
                row["launches"] = {k: ck.LAUNCHES[k] - before[k]
                                   for k in before}
                got = list(zip(cb.dicts["URL"].decode(res.cols["URL"][0]),
                               (int(x) for x in res.cols[col][0])))
                assert got == cb_answers[name], (name, lowering, got[:3])
                assert row["group_layout"][0] == "dense" and \
                    row["group_layout"][1] > 512, row["group_layout"]
                cb_rows.append(row)
                emit({"storage_scan": row})
        launches = dict(ck.LAUNCHES)
        for row in cb_rows:
            k = ("grouped_sum_multi" if row["mode"].endswith("fused")
                 else "grouped_sum")
            assert row["launches"][k] > 0, row
        out["clickbench"] = cb_rows
        out["launches"] = launches
        # the same four scans once more, every kernel call held against
        # its plain version (after the count was read: not counted)
        checks = []
        for name in ("q33", "q36"):
            for lowering, fused in (("fused", True), ("peragg", False)):
                kernels.FUSED_FORCE = fused
                try:
                    got = checked_kernel_calls(
                        ck, lambda: hits.scan(progs[name]))
                finally:
                    kernels.FUSED_FORCE = None
                k = "grouped_sum_multi" if fused else "grouped_sum"
                assert got[k]["calls"] > 0, (name, lowering, got)
                row = {"mode": f"{name}_{lowering}", **got}
                checks.append(row)
                emit({"storage_kernel_check": row})
        out["kernel_checks"] = checks
        del hits
        torch.cuda.empty_cache()

        # 6. TPC-H SQL over sharded tables, the resident tier off so
        # that scans read through the block cache
        with toggles(resident=False):
            out["sql"] = sharded_sql(sql_sf, os.path.join(tmp, "tpch"),
                                     dev, out)
        shutil.rmtree(os.path.join(tmp, "tpch"), ignore_errors=True)
    finally:
        if keep_root:
            out["root"] = tmp
        else:
            shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"storage phase: {out['seconds']:.1f} s; kernel launches of the "
        f"counted GROUP BY URL shard scans {out['launches']}")
    return out


def sharded_sql(sql_sf, root, dev, out) -> list:
    """Phase 9's last section: the 22 TPC-H queries over sharded tables
    (``sharded_tpch``) by the default routing and the walk, each equal
    to the same query over host sources; a row per query."""
    from ydb_tpu_torch.sql.planner import Catalog
    from ydb_tpu_torch.workload import tpch
    from ydb_tpu_torch.workload.queries import TPCH

    sql_tp = tpch.TpchData(sf=sql_sf, seed=42)
    db, host, built = sharded_tpch(sql_tp, root, dev)
    out["sql_build"] = built
    cache = db.block_cache
    catalog = Catalog(schemas={t: sql_tp.schema(t)
                               for t in sql_tp.tables},
                      primary_keys=dict(tpch.PRIMARY_KEYS),
                      dicts=sql_tp.dicts)
    sql_rows = []
    for name in sorted(TPCH, key=lambda q: int(q[1:])):
        hits0, misses0 = cache.hits, cache.misses
        hpq = plan_sql(TPCH[name], host, catalog)
        t0 = time.perf_counter()
        want = run_sql(hpq, host)
        host_s = time.perf_counter() - t0
        pq = plan_sql(TPCH[name], db, catalog)
        with routed() as seen:
            t0 = time.perf_counter()
            got = run_sql(pq, db)
            first_s = time.perf_counter() - t0
        same_result(got, want, name)
        with fusion_force(False):
            wpq = plan_sql(TPCH[name], db, catalog, use_dq=False)
            t0 = time.perf_counter()
            walk = run_sql(wpq, db, False)
            walk_s = time.perf_counter() - t0
        same_result(walk, want, name)
        row = {"query": name, "sf": sql_sf,
               "executor": seen[-1] if seen else "walk",
               "rows": got.num_rows, "first_s": first_s,
               "walk_first_s": walk_s, "host_sources_s": host_s,
               "equals_host_sources": True,
               "block_cache_hits": cache.hits - hits0,
               "block_cache_misses": cache.misses - misses0}
        sql_rows.append(row)
        emit({"storage_sql": row})
    assert cache.hits > 0, "no scan was served by the block cache"
    log(f"storage SQL: block cache {cache.hits} hits, {cache.misses} "
        f"misses, {cache.nbytes} bytes held")
    drop_fused(db)
    del db, host
    torch.cuda.empty_cache()
    return sql_rows


#: TPC-H scale of phase 10's serving path, whose store phases 11, 12, 14,
#: 15 and 16 boot again (SF-10 is phase 9's; SF-1 took the whole script
#: to 1,245.8 s of its 1,200 s on a slow host, phase 10 181 s of it)
SERVING_SF = 0.5
#: hits rows of phase 10's ClickBench: FUSE_MAX_ROWS, the largest table
#: whole-plan fusion (and so the batcher) takes
SERVING_HITS_ROWS = 1 << 17
#: warm runs per TPC-H query over pgwire (one: each more run of the 21
#: fast queries cost the step about 12 s on a slow host)
SERVING_WARM = 1
#: the batched tier's window and group cap (YDB_TPU_TORCH_BATCH_*)
BATCH_WINDOW_MS = 2.0
BATCH_MAX = 8
#: client connections of a batched round, and rounds per measurement
BATCH_CLIENTS = 8
BATCH_ROUNDS = 8
#: rows of hits held back from the stacked round's initial load and
#: inserted over the wire while it runs (the table stays in one shape
#: class, at most FUSE_MAX_ROWS rows)
STACKED_HOLDBACK = 8192
STACKED_INSERT_ROWS = 16
#: the stacked rounds' window: an INSERT's round trip over the wire takes
#: longer than BATCH_WINDOW_MS, so it must hold one group open while the
#: ninth connection commits between two waves of arrivals
STACKED_WINDOW_MS = 500.0


class PgClient:
    """Just enough of the frontend side of PostgreSQL protocol 3.0 (the
    framing of ``tests/test_pgwire.py``): startup with optional extra
    parameters (``tenant``), simple queries, raw field bytes back."""

    def __init__(self, port: int, startup: dict | None = None):
        import socket
        import struct

        self._struct = struct
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=600)
        params = b"user\x00smoke\x00database\x00postgres\x00"
        for k, v in (startup or {}).items():
            params += k.encode() + b"\x00" + v.encode() + b"\x00"
        params += b"\x00"
        self.sock.sendall(struct.pack("!II", len(params) + 8, 196608)
                          + params)
        while True:
            t, body = self._read()
            if t == b"E":
                raise RuntimeError(self._error_text(body))
            if t == b"Z":
                break

    def _exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed")
            buf += chunk
        return buf

    def _read(self):
        t = self._exact(1)
        (n,) = self._struct.unpack("!I", self._exact(4))
        return t, self._exact(n - 4)

    @staticmethod
    def _error_text(body: bytes) -> str:
        fields = {chr(p[0]): p[1:].decode() for p in body.split(b"\x00")
                  if p}
        return fields.get("M", "unknown error")

    def query(self, sql: str):
        """(rows of raw field bytes or None, [(name, oid)], command tags,
        error messages)."""
        st = self._struct
        q = sql.encode() + b"\x00"
        self.sock.sendall(b"Q" + st.pack("!I", len(q) + 4) + q)
        rows, cols, tags, errors = [], [], [], []
        while True:
            t, body = self._read()
            if t == b"T":
                (n,) = st.unpack("!H", body[:2])
                off, cols = 2, []
                for _ in range(n):
                    end = body.index(b"\x00", off)
                    (oid,) = st.unpack("!I", body[end + 7:end + 11])
                    cols.append((body[off:end].decode(), oid))
                    off = end + 19
            elif t == b"D":
                (n,) = st.unpack("!H", body[:2])
                off, row = 2, []
                for _ in range(n):
                    (ln,) = st.unpack("!i", body[off:off + 4])
                    off += 4
                    row.append(None if ln == -1 else body[off:off + ln])
                    off += max(ln, 0)
                rows.append(row)
            elif t == b"C":
                tags.append(body.rstrip(b"\x00").decode())
            elif t == b"E":
                errors.append(self._error_text(body))
            elif t == b"Z":
                return rows, cols, tags, errors

    def ok(self, sql: str):
        rows, cols, tags, errors = self.query(sql)
        assert not errors, (sql[:80], errors)
        return rows, cols

    def close(self) -> None:
        self.sock.sendall(b"X\x00\x00\x00\x04")
        self.sock.close()


_FLOAT_OIDS = (700, 701)


def wire_rows(res) -> list:
    """An OracleTable as the text DataRows the port's pgwire server sends
    for it (the server's own formatting, so equal tables give equal
    bytes)."""
    from ydb_tpu_torch.api.pgwire import _format_value

    cols = []
    for f in res.schema.fields:
        vals, valid = res.cols[f.name]
        valid = np.asarray(valid, dtype=bool)
        if f.type.is_string:
            dec = res.strings(f.name)
            cols.append([dec[i] if valid[i] else None
                         for i in range(res.num_rows)])
        else:
            scale = getattr(f.type, "scale", 0)
            cols.append([_format_value(f.type.kind, scale, vals[i])
                         if valid[i] else None
                         for i in range(res.num_rows)])
    return [list(r) for r in zip(*cols)] if cols else []


def same_wire(got, want, cols, name, rtol=None) -> None:
    """Two results as DataRows: equal bytes, except float columns within
    ``rtol`` when it is given (partial sums merged in another order)."""
    assert len(got) == len(want), (name, len(got), len(want))
    for r, (g, w) in enumerate(zip(got, want)):
        for (col, oid), gv, wv in zip(cols, g, w):
            if gv == wv:
                continue
            assert rtol is not None and oid in _FLOAT_OIDS and \
                gv is not None and wv is not None, (name, r, col, gv, wv)
            np.testing.assert_allclose(float(gv), float(wv), rtol=rtol,
                                       err_msg=f"{name} row {r} {col}")


def wire_digest(rows, cols) -> str:
    """``golden_digest`` of a result read off the wire: the same sha256 as
    ``tests/test_tpch_sql.py`` pins (ints and dictionary strings exact,
    decimals as their scaled integers, dates as days, floats rounded to
    6 places)."""
    import decimal
    import hashlib

    h = hashlib.sha256()
    for i, (name, oid) in enumerate(cols):
        h.update(name.encode())
        vals = []
        for row in rows:
            v = row[i]
            if v is None:
                vals.append(None)
            elif oid in _FLOAT_OIDS:
                vals.append(round(float(v), 6))
            elif oid == 1700:
                d = decimal.Decimal(v.decode())
                vals.append(int(d.scaleb(-d.as_tuple().exponent)))
            elif oid == 1082:
                vals.append(int(np.datetime64(v.decode(), "D")
                                .astype(np.int32)))
            elif oid in (20, 21, 23):
                vals.append(int(v))
            else:
                vals.append(v.decode("latin1"))
        h.update(json.dumps(vals).encode())
    return h.hexdigest()


def wire_table(rows, cols, dicts, aliases):
    """DataRows back into an OracleTable-shaped value for
    ``clickbench._verify``: strings re-encoded into ``dicts``' ids."""
    from types import SimpleNamespace

    out = {}
    for i, (name, oid) in enumerate(cols):
        raw = [r[i] for r in rows]
        valid = np.array([v is not None for v in raw], dtype=bool)
        if oid in _FLOAT_OIDS:
            vals = np.array([float(v) if v is not None else 0.0
                             for v in raw])
        elif oid in (20, 21, 23):
            vals = np.array([int(v) if v is not None else 0 for v in raw],
                            dtype=np.int64)
        elif oid == 1082:
            vals = np.array([int(np.datetime64(v.decode(), "D")
                                 .astype(np.int32)) if v is not None
                             else 0 for v in raw], dtype=np.int32)
        elif oid == 1114:
            vals = np.array([int(np.datetime64(v.decode().replace(" ", "T"),
                                               "us").astype(np.int64))
                             if v is not None else 0 for v in raw],
                            dtype=np.int64)
        else:
            d = dicts[aliases.get(name, name)]
            vals = np.array([d.get(v) if v is not None else 0
                             for v in raw], dtype=np.int32)
        out[name] = (vals, valid)
    return SimpleNamespace(cols=out, num_rows=len(rows))


def create_table_sql(name, schema, pk) -> str:
    """CREATE TABLE for ``schema``; decimals spelled ``decimal(p,s)`` (the
    scheme's own ``decimal(s)`` spelling means scale 0 in DDL)."""
    from ydb_tpu_torch.scheme.model import type_to_str

    def spell(t):
        return (f"decimal(18,{t.scale})" if t.is_decimal
                else type_to_str(t))

    cols = ", ".join(f"{f.name} {spell(f.type)}"
                     + ("" if f.nullable else " NOT NULL")
                     for f in schema.fields)
    return f"CREATE TABLE {name} ({cols}, PRIMARY KEY ({', '.join(pk)}))"


def bulk_load(cluster, name, cols, dicts, lo=0, hi=None) -> float:
    """Rows ``lo:hi`` of ``cols`` into the cluster's table ``name``
    through ``ShardedTable.insert`` (the reference's BulkUpsert path):
    string columns go in as ids of ``dicts``, whose values were entered
    into the cluster's dictionaries first, in order, so the ids agree.
    Returns the seconds."""
    t0 = time.perf_counter()
    t = cluster.tables[name]
    for f in t.schema.fields:
        if f.type.is_string:
            d = cluster.dicts.for_column(f.name)
            src = dicts[f.name].values
            if len(d) < len(src):
                d.encode(list(src[len(d):]))
            assert len(d) == len(src), (name, f.name)
    t.insert({k: np.asarray(v)[lo:hi] for k, v in cols.items()})
    cluster._invalidate_plans()
    return time.perf_counter() - t0


def insert_values_sql(name, schema, cols, dicts, rows) -> str:
    """An INSERT statement with the literal values of ``rows`` of
    ``cols`` (the ninth connection's writes)."""
    out = []
    for r in rows:
        vals = []
        for f in schema.fields:
            v = cols[f.name][r]
            if f.type.is_string:
                s = dicts[f.name].values[int(v)].decode("latin1")
                vals.append("'" + s.replace("'", "''") + "'")
            elif f.type.kind.name == "DATE":
                vals.append(f"date '{np.datetime64(int(v), 'D')}'")
            else:
                vals.append(str(int(v)))
        out.append("(" + ", ".join(vals) + ")")
    return f"INSERT INTO {name} VALUES " + ", ".join(out)


def pct(xs, q) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def concurrent_queries(port, work, startup=None):
    """``work[i]`` (a list of SQL texts) on client connection i, all
    connections started together; per statement (client, sql, rows,
    cols, errors, seconds) and the wall seconds of the round."""
    import threading

    clients = [PgClient(port, startup) for _ in work]
    barrier = threading.Barrier(len(work))
    out = [[] for _ in work]
    fail = []

    def run(i):
        try:
            barrier.wait()
            for sql in work[i]:
                t0 = time.perf_counter()
                rows, cols, _tags, errors = clients[i].query(sql)
                out[i].append((i, sql, rows, cols, errors,
                               time.perf_counter() - t0))
        except Exception as e:  # noqa: BLE001 - raised below
            fail.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(work))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    for c in clients:
        c.close()
    if fail:
        raise fail[0]
    return [s for per in out for s in per], wall


def waves(port, sql, half, between):
    """``sql`` on ``half`` connections, then ``between()`` (the ninth
    connection's INSERT) once they have all sent it, then ``sql`` on
    ``half`` more: with a window longer than the INSERT, one batch group
    whose members read two snapshots. Statements as
    ``concurrent_queries`` returns them."""
    import threading

    clients = [PgClient(port) for _ in range(2 * half)]
    sent = threading.Semaphore(0)
    out, fail = [], []

    def run(c):
        try:
            sent.release()
            t0 = time.perf_counter()
            rows, cols, _tags, errors = c.query(sql)
            out.append((0, sql, rows, cols, errors,
                        time.perf_counter() - t0))
        except Exception as e:  # noqa: BLE001 - raised below
            fail.append(e)

    t0 = time.perf_counter()
    first = [threading.Thread(target=run, args=(c,))
             for c in clients[:half]]
    for t in first:
        t.start()
    for _ in first:
        sent.acquire()
    time.sleep(0.02)  # the first wave reaches its snapshot
    between()
    second = [threading.Thread(target=run, args=(c,))
              for c in clients[half:]]
    for t in second:
        t.start()
    for t in first + second:
        t.join(600)
    wall = time.perf_counter() - t0
    for c in clients:
        c.close()
    if fail:
        raise fail[0]
    return out, wall


class armed:
    """The cluster's batcher at ``window_ms`` / ``max_batch`` for a block
    (what ``YDB_TPU_TORCH_BATCH_WINDOW_MS`` / ``_BATCH_MAX`` set at
    boot), restored after."""

    def __init__(self, cluster, window_ms, max_batch=BATCH_MAX):
        self.bt = cluster.batcher
        self.want = (float(window_ms), max_batch)

    def __enter__(self):
        self.saved = (self.bt.window_ms, self.bt.max_batch)
        self.bt.window_ms, self.bt.max_batch = self.want
        return self.bt

    def __exit__(self, *exc):
        self.bt.window_ms, self.bt.max_batch = self.saved
        return False


def serving_boot(root, dev):
    from ydb_tpu_torch.api.pgwire import PgWireServer
    from ydb_tpu_torch.config import AppConfig
    from ydb_tpu_torch.engine.blobs import DirBlobStore
    from ydb_tpu_torch.kqp.session import Cluster

    t0 = time.perf_counter()
    cluster = Cluster(store=DirBlobStore(root), device=dev,
                      config=AppConfig())
    srv = PgWireServer(cluster, port=0).start()
    return cluster, srv, time.perf_counter() - t0


def serving_tpch(cluster, srv, sf, dev, warm=SERVING_WARM) -> tuple:
    """Step 2: the eight TPC-H tables created over the wire, bulk loaded,
    the 22 queries over pgwire (first and warm), each equal to
    ``execute_plan`` over host ColumnSources of the same tables."""
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.plan import Database
    from ydb_tpu_torch.workload import tpch
    from ydb_tpu_torch.workload.queries import TPCH

    tp = tpch.TpchData(sf=sf, seed=42)
    cl = PgClient(srv.port)
    load_s = {}
    for t, cols in tp.tables.items():
        cl.ok(create_table_sql(t, tp.schema(t), tpch.PRIMARY_KEYS[t]))
        load_s[t] = bulk_load(cluster, t, cols, tp.dicts)
    log(f"serving: TPC-H sf {sf} created over pgwire and bulk loaded "
        f"({cluster.n_shards} shards a table) in {sum(load_s.values()):.2f} "
        f"s")
    host = Database(sources={t: ColumnSource(c, tp.schema(t), cluster.dicts)
                             for t, c in tp.tables.items()},
                    dicts=cluster.dicts, device=dev)
    catalog = cluster.catalog()
    rows_out = []
    for name in sorted(TPCH, key=lambda q: int(q[1:])):
        sql = TPCH[name]
        hpq = plan_sql(sql, host, catalog)
        hres = run_sql(hpq, host)
        hres.dicts = cluster.result_dicts(hres.schema, hpq.dict_aliases)
        want = wire_rows(hres)
        torch.cuda.reset_peak_memory_stats(dev)
        with routed() as seen:
            t0 = time.perf_counter()
            rows, cols = cl.ok(sql)
            first_s = time.perf_counter() - t0
        first = cluster.profiles.recent()[-1]
        executor = seen[-1] if seen else "walk"
        same_wire(rows, want, cols, name, rtol=1e-12)
        warm_s = []
        for _ in range(warm):
            t0 = time.perf_counter()
            again, _ = cl.ok(sql)
            warm_s.append(time.perf_counter() - t0)
            same_wire(again, rows, cols, name)
        last = cluster.profiles.recent()[-1]
        row = {"query": name, "sf": sf, "executor": executor,
               "rows": len(rows), "first_s": first_s,
               "warm_median_s": statistics.median(warm_s),
               "warm_s": warm_s,
               "plan_cache": [first.plan_cache, last.plan_cache],
               "compile_cache": [first.compile_cache, last.compile_cache],
               "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
               "equals_host_sources": True}
        rows_out.append(row)
        emit({"serving_sql": row})
    cl.close()
    log(f"serving TPC-H sf {sf}: 22 queries over pgwire equal host "
        f"sources; first runs {sum(r['first_s'] for r in rows_out):.3f} s, "
        f"warm medians {sum(r['warm_median_s'] for r in rows_out):.3f} s "
        f"summed")
    return rows_out, tp


def serving_goldens(root, dev) -> dict:
    """Step 2, last part: the 22 golden digests at sf 0.01 through a second
    port Cluster over pgwire."""
    from ydb_tpu_torch.workload import tpch
    from ydb_tpu_torch.workload.queries import TPCH

    golden = json.load(open(os.path.join(HERE, "tests", "golden_tpch.json")))
    tp = tpch.TpchData(sf=golden["sf"], seed=golden["seed"])
    cluster, srv, _ = serving_boot(root, dev)
    try:
        cl = PgClient(srv.port)
        for t, cols in tp.tables.items():
            cl.ok(create_table_sql(t, tp.schema(t), tpch.PRIMARY_KEYS[t]))
            bulk_load(cluster, t, cols, tp.dicts)
        for name, want in golden["queries"].items():
            rows, cols = cl.ok(TPCH[name])
            assert len(rows) == want["rows"], (name, len(rows))
            assert wire_digest(rows, cols) == want["sha"], name
        cl.close()
    finally:
        srv.stop()
        cluster.stop()
    log(f"serving goldens: {len(golden['queries'])} queries at sf "
        f"{golden['sf']} over pgwire match tests/golden_tpch.json")
    return {"queries": len(golden["queries"]), "sf": golden["sf"]}


def serving_clickbench(cluster, srv, cb) -> list:
    """Step 3a: hits created over the wire and bulk loaded; the 43 queries
    over pgwire, each equal to ``reference_answers``."""
    from types import SimpleNamespace

    from ydb_tpu_torch.workload import clickbench

    cl = PgClient(srv.port)
    cl.ok(create_table_sql("hits", clickbench.HITS_SCHEMA, ("WatchID",)))
    bulk_load(cluster, "hits", cb.hits, cb.dicts)
    want = clickbench.reference_answers(cb)
    out = []
    for name in sorted(clickbench.QUERIES, key=lambda q: int(q[1:])):
        sql = clickbench.QUERIES[name]
        with routed() as seen:
            t0 = time.perf_counter()
            rows, cols = cl.ok(sql)
            first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again, _ = cl.ok(sql)
        warm_s = time.perf_counter() - t0
        same_wire(again, rows, cols, name)
        # derived string columns (e.g. a cut URL host) get dictionaries
        # of the cluster's at plan time
        aliases = cluster.plan(sql)[1]
        clickbench._verify(
            name, wire_table(rows, cols, cluster.dicts, aliases),
            want[name], SimpleNamespace(hits=cb.hits, dicts=cluster.dicts),
            SimpleNamespace(dict_aliases=aliases))
        row = {"query": name, "hits_rows": len(cb.hits["WatchID"]),
               "executor": seen[-1] if seen else "walk",
               "rows": len(rows), "first_s": first_s, "warm_s": warm_s,
               "canondata_checked": True}
        out.append(row)
        emit({"serving_clickbench": row})
    cl.close()
    routes = collections.Counter(r["executor"] for r in out)
    log(f"serving ClickBench at {len(cb.hits['WatchID'])} rows: 43 queries "
        f"over pgwire equal reference_answers; executors {dict(routes)}")
    return out


def batch_stats(rounds, wall) -> dict:
    lat = [s[5] for r in rounds for s in r]
    n = len(lat)
    return {"statements": n, "seconds": wall,
            "statements_per_s": n / wall,
            "p50_s": pct(lat, 0.5), "p99_s": pct(lat, 0.99)}


def serving_batched(cluster, srv, cb) -> dict:
    """Step 3b: the batched tier. Dedup: BATCH_CLIENTS connections send the
    same q33 at once, serial (window 0) against batched; stacked: a mix
    of q33/q36/q38 while a ninth connection inserts rows between
    arrivals. Every batched result equals the serial result at the same
    snapshot, byte for byte."""
    import threading

    from ydb_tpu_torch.plan import execute_plan, to_host
    from ydb_tpu_torch.workload import clickbench

    q = clickbench.QUERIES
    bt = cluster.batcher
    out: dict = {}
    want33 = None
    serial, batched = [], []
    serial_wall = batched_wall = 0.0
    snaps = []
    for r in range(BATCH_ROUNDS):
        # serial and batched rounds in turn, so both see the same card
        stmts, wall = concurrent_queries(
            srv.port, [[q["q33"]]] * BATCH_CLIENTS)
        serial.append(stmts)
        serial_wall += wall
        snaps.append(bt.snapshot())
        with armed(cluster, BATCH_WINDOW_MS):
            stmts, wall = concurrent_queries(
                srv.port, [[q["q33"]]] * BATCH_CLIENTS)
        batched.append(stmts)
        batched_wall += wall
    for s in [s for r in serial + batched for s in r]:
        assert not s[4], s[4]
        if want33 is None:
            want33 = s[2]
        assert s[2] == want33, "q33 differs between connections"
    snap = bt.snapshot()
    assert snaps[0]["batches"] == 0, "the window-0 rounds batched"
    assert snap["dedup_dispatches"] > 0, snap
    out["dedup"] = {"serial": batch_stats(serial, serial_wall),
                    "batched": batch_stats(batched, batched_wall),
                    "batcher": snap}
    log(f"serving batched dedup: q33 x {BATCH_CLIENTS} connections x "
        f"{BATCH_ROUNDS} rounds, serial {out['dedup']['serial']} vs "
        f"batched {out['dedup']['batched']}; batcher {snap}")

    # stacked: hits reloaded short of the shape class's top, then grown
    # over the wire while eight connections read
    cl = PgClient(srv.port)
    cl.ok("DROP TABLE hits")
    cl.ok(create_table_sql("hits", clickbench.HITS_SCHEMA, ("WatchID",)))
    n = len(cb.hits["WatchID"])
    bulk_load(cluster, "hits", cb.hits, cb.dicts, 0, n - STACKED_HOLDBACK)
    pool0 = cluster._compile_cache.pool_bytes()
    recorded = []
    rec_lock = threading.Lock()
    tls = threading.local()
    real_snapshot_db = cluster.snapshot_db
    real_execute = type(cluster.session()).execute

    def snapshot_db(snap=None, **kw):
        snap = cluster.coordinator.read_snapshot() if snap is None else snap
        tls.snap = snap
        return real_snapshot_db(snap, **kw)

    def execute(sess, sql, *a, **kw):
        tls.snap = None
        res = real_execute(sess, sql, *a, **kw)
        if sql.lstrip().upper().startswith("SELECT"):
            with rec_lock:
                recorded.append((sql, tls.snap, res))
        return res

    cluster.snapshot_db = snapshot_db
    session_cls = type(cluster.session())
    session_cls.execute = execute
    next_row = [n - STACKED_HOLDBACK]
    inserts = []
    ins = PgClient(srv.port)

    def insert_rows():
        lo = next_row[0]
        hi = min(n, lo + STACKED_INSERT_ROWS)
        ins.ok(insert_values_sql("hits", clickbench.HITS_SCHEMA, cb.hits,
                                 cb.dicts, range(lo, hi)))
        next_row[0] = hi
        inserts.append(hi - lo)

    s0 = bt.snapshot()
    stacked_rounds, wall_sum = [], 0.0
    half = BATCH_CLIENTS // 2
    try:
        with armed(cluster, STACKED_WINDOW_MS):
            for name in ("q33", "q36", "q38"):
                # half the connections arrive and read the table; the
                # ninth commits rows; the other half arrive and read the
                # grown table: one group, two snapshots
                stmts, wall = waves(srv.port, q[name], half, insert_rows)
                stacked_rounds.append(stmts)
                wall_sum += wall
    finally:
        ins.close()
        cluster.snapshot_db = real_snapshot_db
        session_cls.execute = real_execute
    for s in [s for r in stacked_rounds for s in r]:
        assert not s[4], s[4]
    snap = bt.snapshot()
    assert snap["stacked_dispatches"] >= s0["stacked_dispatches"] + 3, snap
    assert len({r[1] for r in recorded}) >= 4, "one snapshot per wave"
    # every recorded SELECT against the serial path at its snapshot
    checked = 0
    for sql, snapno, res in recorded:
        plan = cluster.plan(sql)[0]
        serial_res = to_host(execute_plan(plan, cluster.snapshot_db(snapno)))
        for col in res.schema.names:
            (gv, go), (wv, wo) = res.cols[col], serial_res.cols[col]
            assert np.array_equal(go, wo) and np.array_equal(
                np.asarray(gv)[go], np.asarray(wv)[wo]), (sql[:40], col)
        checked += 1
    pool_before = cluster._compile_cache.pool_bytes()
    cluster._invalidate_plans()
    torch.cuda.synchronize()
    pool_after = cluster._compile_cache.pool_bytes()
    out["stacked"] = {
        "rounds": len(stacked_rounds), "window_ms": STACKED_WINDOW_MS,
        "rows_inserted": sum(inserts),
        "inserts": len(inserts), "checked_against_serial": checked,
        **batch_stats(stacked_rounds, wall_sum),
        "batcher": snap,
        "graph_captures_per_batch_size": dict(bt.graph_captures),
        "capture_dispatch_seconds": bt.capture_seconds,
        "pool_bytes_at_reload": pool0,
        "pool_bytes_before_invalidation": pool_before,
        "pool_bytes_after_invalidation": pool_after}
    assert pool_after == 0, pool_after
    log(f"serving batched stacked: {out['stacked']}")
    return out


def serving_tenants(cluster, srv) -> dict:
    """Step 4: two tenants behind the front door."""
    from ydb_tpu_torch import serving
    from ydb_tpu_torch.workload import clickbench

    reg = serving.TenantRegistry()
    reg.register("gold", weight=3.0, max_inflight=4, queue_size=8)
    reg.register("bronze", weight=1.0, max_inflight=1, queue_size=0)
    fd = serving.install(cluster, reg)
    q = clickbench.QUERIES
    base = fd.snapshot()
    stmts, _ = concurrent_queries(srv.port, [[q["q33"], q["q36"]]] * 4,
                                  startup={"tenant": "gold"})
    assert all(not s[4] for s in stmts), [s[4] for s in stmts]
    # a held bronze seat: the next bronze statement is over its cap
    held = fd.admit("bronze")
    try:
        cl = PgClient(srv.port, {"tenant": "bronze"})
        _, _, _, errors = cl.query(q["q33"])
        cl.close()
    finally:
        held.release()
    assert errors and "bronze" in errors[0], errors
    burst, _ = concurrent_queries(srv.port, [[q["q36"]]] * 6,
                                  startup={"tenant": "bronze"})
    shed = [s[4][0] for s in burst if s[4]]
    assert all("bronze" in e for e in shed), shed
    snap = fd.snapshot()
    assert snap["gold"]["admitted"] >= base["gold"]["admitted"] + 8, snap
    assert snap["bronze"]["shed"] >= 1, snap
    gauges = {}
    for tenant in ("gold", "bronze"):
        g = cluster.counters.group(tenant=tenant, query_class="select_agg")
        gauges[tenant] = {"p50_s": g.counter("query_latency_p50").value,
                          "p99_s": g.counter("query_latency_p99").value}
    assert gauges["gold"]["p50_s"] > 0 and gauges["gold"]["p99_s"] > 0, \
        gauges
    cluster.front_door = None
    cluster.workload = None
    out = {"front_door": snap, "latency": gauges,
           "held_seat_error": errors[0], "burst_shed": len(shed)}
    log(f"serving tenants: {out}")
    return out


def serving_kernels(cluster, ck) -> dict:
    """Step 5, second part: q33 and q36 through a Session with fusion off,
    on the fused group-by lowering (``grouped_sum_multi``) and on the
    per-aggregate one (``grouped_sum``), every kernel call held against
    its plain version (these launches are not counted)."""
    from ydb_tpu_torch.ssa import kernels
    from ydb_tpu_torch.workload import clickbench

    s = cluster.session()
    out = {}
    try:
        with fusion_force(False):
            for lowering, force, kernel in (
                    ("fused", None, "grouped_sum_multi"),
                    ("peragg", False, "grouped_sum")):
                kernels.FUSED_FORCE = force
                for name in ("q33", "q36"):
                    sql = clickbench.QUERIES[name]
                    s.execute(sql)  # compiles outside the checked run
                    row = checked_kernel_calls(
                        ck, lambda sql=sql: s.execute(sql))
                    assert row[kernel]["calls"] > 0, (name, row)
                    out[f"{name}_{lowering}"] = row
    finally:
        kernels.FUSED_FORCE = None
    cluster._invalidate_plans()
    emit({"serving_kernel_check": out})
    return out


def serving_concurrency(cluster, cb) -> dict:
    """Step 7: eight threads run walk, DQ and fused statements through
    Sessions while a plan not seen before is captured; every result
    equals its serial answer."""
    import threading

    from ydb_tpu_torch.workload import clickbench
    from ydb_tpu_torch.workload.queries import TPCH

    stmts = {"walk_q1": TPCH["q1"], "walk_q6": TPCH["q6"],
             "dq_q3": TPCH["q3"], "dq_q10": TPCH["q10"],
             "fused_q33": clickbench.QUERIES["q33"],
             "fused_q36": clickbench.QUERIES["q36"],
             "fused_q7": clickbench.QUERIES["q7"]}
    s = cluster.session()
    want = {k: wire_rows(s.execute(v)) for k, v in stmts.items()}
    fresh = ("select URL, count(*) as c from hits where RegionID <> 0 "
             "group by URL order by c desc, URL limit 12")
    names = list(stmts)
    errors, got = [], []
    barrier = threading.Barrier(9)

    def worker(i):
        try:
            sess = cluster.session()
            barrier.wait()
            for k in range(3):
                name = names[(i + k) % len(names)]
                got.append((name, wire_rows(sess.execute(stmts[name]))))
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    fresh_out = []

    def capturer():
        try:
            sess = cluster.session()
            barrier.wait()
            time.sleep(0.01)
            fresh_out.append(wire_rows(sess.execute(fresh)))
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    captures0 = sum(p.captures for p in _fused_in(cluster))
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(8)] + [threading.Thread(target=capturer)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    for name, rows in got:
        assert rows == want[name], name
    assert fresh_out and fresh_out[0] == wire_rows(s.execute(fresh))
    out = {"statements": len(got) + 1, "seconds": wall,
           "captures": sum(p.captures for p in _fused_in(cluster))
           - captures0}
    assert out["captures"] >= 1, out
    log(f"serving concurrency: {out}")
    return out


def _fused_in(cluster) -> list:
    from ydb_tpu_torch.ssa.plan_fuse import FusedPlan

    return [v for v in dict.values(cluster._compile_cache)
            if isinstance(v, FusedPlan)]


def serving_reboot(root, dev, want: dict) -> dict:
    """Step 6: a second Cluster booted from the same directory answers
    ``want`` (sql -> DataRows) byte for byte over a new server."""
    cluster, srv, boot_s = serving_boot(root, dev)
    try:
        cl = PgClient(srv.port)
        for sql, rows in want.items():
            got, _ = cl.ok(sql)
            assert got == rows, sql[:60]
        cl.close()
    finally:
        srv.stop()
        cluster.stop()
    log(f"serving reboot: booted in {boot_s:.2f} s, {len(want)} statements "
        f"bit-identical")
    return {"boot_s": boot_s, "statements": len(want)}


def serving_phase(dev, ck, sf: float = SERVING_SF,
                  hits_rows: int = SERVING_HITS_ROWS,
                  keep_root: bool = False) -> dict:
    """Phase 10: the session and serving plane (see the module docstring).
    Returns every measurement; ``launches`` are the CUDA kernels'
    launches of steps 2-3. With ``keep_root`` the cluster's directory
    stays for phase 11 (``out["root"]``, the caller removes it), with the
    unsanitized answers of phase 11's statements (``sanitize_want``) and
    the disarmed q33 seconds over pgwire (``sanitize_disarmed``)."""
    import shutil
    import tempfile

    from ydb_tpu_torch.workload import clickbench
    from ydb_tpu_torch.workload.queries import TPCH

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="serving_")
    out: dict = {}
    try:
        cluster, srv, out["boot_s"] = serving_boot(
            os.path.join(root, "main"), dev)
        ck.reset_launches()
        out["tpch"], tp = serving_tpch(cluster, srv, sf, dev)
        out["tpch_table_rows"] = {t: len(next(iter(c.values())))
                                  for t, c in tp.tables.items()}
        cb = clickbench.ClickBenchData(rows=hits_rows, seed=42)
        out["clickbench"] = serving_clickbench(cluster, srv, cb)
        out["batched"] = serving_batched(cluster, srv, cb)
        out["launches"] = dict(ck.LAUNCHES)
        log(f"serving launches (steps 2-3, a replay counting the kernels "
            f"its graph holds): {out['launches']}")
        assert out["launches"]["grouped_sum_multi"] > 0, out["launches"]
        out["kernel_check"] = serving_kernels(cluster, ck)
        out["concurrency"] = serving_concurrency(cluster, cb)
        out["tenants"] = serving_tenants(cluster, srv)
        cl = PgClient(srv.port)
        want = {sql: cl.ok(sql)[0] for sql in (
            TPCH["q1"], TPCH["q6"], clickbench.QUERIES["q33"])}
        if keep_root:
            out["sanitize_want"] = {
                name: cl.ok(sql)[0]
                for name, sql in sanitize_statements().items()}
        cl.close()
        if keep_root:
            q33 = next(r for r in out["clickbench"] if r["query"] == "q33")
            out["sanitize_disarmed"] = {
                "runs": q33_over_wire(srv.port),
                "phase10_warm_s": q33["warm_s"]}
        srv.stop()
        cluster.stop()
        del cluster
        out["reboot"] = serving_reboot(os.path.join(root, "main"), dev,
                                       want)
        out["goldens"] = serving_goldens(os.path.join(root, "golden"), dev)
    finally:
        if keep_root:
            out["root"] = root
        else:
            shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"serving phase: {out['seconds']:.1f} s")
    return out


# ---------------- phase 11: the sanitizers ----------------

#: warm runs of each phase-11 statement after its free pass (the
#: reference's warmup rule: the first statement of a label is free)
SANITIZE_WARM = 2
#: warm q33 runs over one pgwire connection for the disarmed (phase 10's
#: cluster) and armed medians
SANITIZE_Q33_RUNS = 9
#: the disarmed q33 median over pgwire may exceed phase 10's warm q33 by
#: this factor at most: host timing noise on a shared machine, not a
#: speed claim (a disarmed sanitizer patches nothing)
SANITIZE_NOISE = 2.0
#: phase 11's time limit, seconds of script time
SANITIZE_BUDGET_S = 90.0


def sanitize_statements() -> dict:
    """Phase 11's SQL statements (name -> text)."""
    from ydb_tpu_torch.workload import clickbench
    from ydb_tpu_torch.workload.queries import TPCH

    return {"q1": TPCH["q1"], "q6": TPCH["q6"], "q3": TPCH["q3"],
            "q33": clickbench.QUERIES["q33"],
            "q36": clickbench.QUERIES["q36"]}


def q33_over_wire(port, runs: int = SANITIZE_Q33_RUNS) -> list:
    """Seconds of ``runs`` warm q33 statements over one connection (one
    statement first, not timed)."""
    from ydb_tpu_torch.workload import clickbench

    sql = clickbench.QUERIES["q33"]
    cl = PgClient(port)
    cl.ok(sql)
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        cl.ok(sql)
        out.append(time.perf_counter() - t0)
    cl.close()
    return out


class sanitizers_armed:
    """All four runtime sanitizers armed for a block (tsan, leaksan,
    syncsan, memsan through their ``activate()``), with no fallback: a
    seam that did not install, or a CUDA sync debug mode that is not
    "warn", raises. On exit every seam must be restored."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"

    def __enter__(self):
        from ydb_tpu_torch.analysis import leaksan, memsan, sanitizer, \
            syncsan

        self.orig = (torch.Tensor.item, torch.Tensor.to, torch.zeros,
                     torch.cuda.synchronize)
        self.ctx = [sanitizer.activate(), leaksan.activate(),
                    syncsan.activate(), memsan.activate()]
        for c in self.ctx:
            c.__enter__()
        if not (syncsan.installed() and memsan.installed()
                and sanitizer.enabled() and leaksan.enabled()):
            raise RuntimeError("a sanitizer did not arm")
        if (torch.Tensor.item is self.orig[0] or torch.zeros is self.orig[2]
                or torch.cuda.synchronize is self.orig[3]):
            raise RuntimeError("a sanitizer seam did not install")
        if self.cuda and torch.cuda.get_sync_debug_mode() != 1:
            raise RuntimeError("CUDA sync debug mode is not 'warn' while "
                               "syncsan is armed")
        return self

    def __exit__(self, *exc):
        for c in reversed(self.ctx):
            c.__exit__(None, None, None)
        now = (torch.Tensor.item, torch.Tensor.to, torch.zeros,
               torch.cuda.synchronize)
        if any(a is not b for a, b in zip(now, self.orig)):
            raise RuntimeError("a sanitizer seam was not restored")
        if self.cuda and torch.cuda.get_sync_debug_mode() != 0:
            raise RuntimeError("CUDA sync debug mode not restored")
        return False


def sanitize_row(label, path, warm, ss, ms, peak, base) -> dict:
    """One ``{"sanitize": ...}`` line; raises when a warm statement
    captured, built, compiled or allocated outside a memsan seam."""
    from ydb_tpu_torch.analysis import leaksan, sanitizer

    row = {"statement": label, "path": path, "warm": warm,
           "syncs_seams": ss["syncs"], "syncs_debug": ss["debug_syncs"],
           "h2d": ss["h2d"], "d2h": ss["d2h"],
           "captures": ss["captures"], "builds": ss["builds"],
           "compiles": ss["compiles"],
           "charged_peak_bytes": ms["peak"], "charges": ms["charges"],
           "unbudgeted": ms["unbudgeted"],
           "allocator_peak_bytes": peak,
           "allocator_peak_over_start": peak - base,
           "leak_handles": leaksan.counts(),
           "races": len(sanitizer.reports())}
    emit({"sanitize": row})
    assert row["unbudgeted"] == 0, row
    assert not row["races"], sanitizer.reports()
    if warm:
        assert row["captures"] == row["builds"] == row["compiles"] == 0, row
    return row


def _peak_start(dev) -> int:
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _peak_end(dev) -> int:
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev)


def sanitize_scan(tp, dev) -> tuple:
    """Phase 11, scan path: TPC-H Q1 and Q6 through ``ScanExecutor`` over
    phase 3's lineitem (its read columns held on the card), armed by the
    caller; each sanitized result equals the same run unsanitized, which
    the caller made first (``want``)."""
    from ydb_tpu_torch import dtypes
    from ydb_tpu_torch.engine.scan import ColumnSource, ScanExecutor
    from ydb_tpu_torch.workload import tpch

    li = tp.tables["lineitem"]
    progs = {"q1": tpch.q1_program(), "q6": tpch.q6_program()}
    host = ColumnSource(li, tpch.LINEITEM_SCHEMA, tp.dicts)
    need = tuple(dict.fromkeys(
        c for p in progs.values()
        for c in ScanExecutor(p, host, device=dev).read_cols))
    held = ColumnSource({c: li[c] for c in need},
                        dtypes.Schema(tuple(tpch.LINEITEM_SCHEMA.field(c)
                                            for c in need)),
                        tp.dicts).to_device(dev)
    exs = {k: ScanExecutor(p, held, block_rows=BLOCK_ROWS, device=dev)
           for k, p in progs.items()}

    def run(k):
        ex = exs[k]
        return ex.run_stream(held.blocks(BLOCK_ROWS, ex.read_cols,
                                         device=dev)).host_columns()

    return exs, run


def scan_statements(run, dev, want) -> list:
    """The armed scan statements: a free pass then SANITIZE_WARM warm runs
    of each, one line each."""
    from ydb_tpu_torch.analysis import memsan, syncsan

    rows = []
    for k in ("q1", "q6"):
        for i in range(1 + SANITIZE_WARM):
            label = f"{k}_scan"
            base = _peak_start(dev)
            st = syncsan.begin_statement(label)
            mt = memsan.begin_statement(label)
            got = run(k)
            ss = syncsan.end_statement(st, enforce=False)
            ms = memsan.end_statement(mt, enforce=False)
            peak = _peak_end(dev)
            for part in (0, 1):
                for c, v in want[k][part].items():
                    if v.dtype.kind == "f":  # sums may reassociate
                        np.testing.assert_allclose(got[part][c], v,
                                                   rtol=1e-12, atol=0)
                    else:
                        assert np.array_equal(got[part][c], v), (label, c)
            rows.append(sanitize_row(label, "scan", i > 0, ss, ms, peak,
                                     base))
    return rows


def session_statements(cluster, cl, dev, stmts, want,
                       suffix="") -> list:
    """Each statement over the pgwire connection ``cl``: a free pass and
    SANITIZE_WARM warm runs, each equal to phase 10's unsanitized answer
    (floats rtol 1e-12, their sums may reassociate; the rest byte for
    byte), one ``{"sanitize": ...}`` line each."""
    rows = []
    for name, sql in stmts.items():
        for i in range(1 + SANITIZE_WARM):
            base = _peak_start(dev)
            with routed() as seen:
                got, cols = cl.ok(sql)
            peak = _peak_end(dev)
            same_wire(got, want[name], cols, name + suffix, rtol=1e-12)
            prof = cluster.profiles.recent()[-1]
            rows.append(sanitize_row(
                name + suffix, seen[-1] if seen else "walk", i > 0,
                prof.syncsan, prof.memsan, peak, base))
    return rows


def peragg_statements(cluster, cl, dev, stmts, want) -> list:
    """q33 and q36 with fusion off on the per-aggregate group-by lowering,
    which launches ``grouped_sum`` once per aggregate (the fused lowering
    launches ``grouped_sum_multi``); the plans made meanwhile are dropped
    after."""
    from ydb_tpu_torch.ssa import kernels

    cluster._invalidate_plans()
    kernels.FUSED_FORCE = False
    try:
        with fusion_force(False):
            return session_statements(
                cluster, cl, dev, {k: stmts[k] for k in ("q33", "q36")},
                want, suffix="_peragg")
    finally:
        kernels.FUSED_FORCE = None
        cluster._invalidate_plans()


def sanitize_phase(dev, ck, root, tp, want, disarmed) -> dict:
    """Phase 11 (see the module docstring). ``root`` is phase 10's store,
    ``tp`` phase 3's TPC-H data, ``want`` the unsanitized wire rows of
    ``sanitize_statements()`` from phase 10's cluster, ``disarmed`` the
    disarmed q33 seconds over pgwire there."""
    from ydb_tpu_torch.analysis import leaksan, sanitizer
    from ydb_tpu_torch.workload import clickbench

    t_phase = time.perf_counter()
    out: dict = {}
    # the scan path's unsanitized answers first
    exs, run = sanitize_scan(tp, dev)
    scan_want = {k: run(k) for k in exs}
    stmts = sanitize_statements()
    with sanitizers_armed(dev):
        out["scan"] = scan_statements(run, dev, scan_want)
        cluster, srv, out["boot_s"] = serving_boot(root, dev)
        ck_ok = dev.type == "cuda"
        if ck_ok:
            ck.reset_launches()
        cl = PgClient(srv.port)
        out["session"] = session_statements(cluster, cl, dev, stmts, want)
        # one batched q33 round: eight connections at once
        n0 = len(cluster.profiles.recent())
        with armed(cluster, BATCH_WINDOW_MS):
            batch, wall = concurrent_queries(
                srv.port, [[stmts["q33"]]] * BATCH_CLIENTS)
        for st in batch:
            assert not st[4], st[4]
            same_wire(st[2], want["q33"], st[3], "q33 batched")
        profs = cluster.profiles.recent()[n0:]
        assert len(profs) == BATCH_CLIENTS, len(profs)
        agg = {k: max(p.syncsan[k] for p in profs)
               for k in profs[0].syncsan}
        magg = {k: max(p.memsan[k] for p in profs) for k in profs[0].memsan}
        row = sanitize_row("q33_batched_round", "batched", True, agg, magg,
                           0, 0)
        row.update(statements=len(profs), wall_s=wall,
                   batches=cluster.batcher.snapshot()["batches"])
        out["batched"] = row
        out["q33_armed_s"] = q33_over_wire(srv.port)
        # q33 and q36 on the per-aggregate lowering (``grouped_sum``), last:
        # they drop the plans the statements above made warm
        out["session"] += peragg_statements(cluster, cl, dev, stmts, want)
        cl.close()
        if ck_ok:
            # the main path's launches, before the check's own
            out["launches"] = dict(ck.LAUNCHES)
            log(f"sanitize launches (session statements, batched round, "
                f"q33 over pgwire): {out['launches']}")
            assert all(v > 0 for v in out["launches"].values()), \
                out["launches"]
            out["kernel_check"] = serving_kernels(cluster, ck)
        srv.stop()
        live = leaksan.counts()
        cluster.stop()  # raises LeakError when a handle outlived it
        out["leaks_at_stop"] = leaksan.counts()
        out["races"] = sanitizer.reports()
        emit({"sanitize_stop": {"leak_handles_before_stop": live,
                                "leak_handles_at_stop":
                                out["leaks_at_stop"],
                                "races": out["races"]}})
        assert not out["leaks_at_stop"], out["leaks_at_stop"]
        assert not out["races"], out["races"]
    out["q33_disarmed_s"] = disarmed["runs"]
    med_d = statistics.median(disarmed["runs"])
    med_a = statistics.median(out["q33_armed_s"])
    out["overhead"] = {
        "q33_disarmed_median_s": med_d, "q33_armed_median_s": med_a,
        "armed_over_disarmed": med_a / med_d,
        "phase10_q33_warm_s": disarmed["phase10_warm_s"],
        "disarmed_over_phase10": med_d / disarmed["phase10_warm_s"]}
    emit({"sanitize_overhead": out["overhead"]})
    assert med_d <= SANITIZE_NOISE * disarmed["phase10_warm_s"], \
        out["overhead"]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"sanitize phase: {out['seconds']:.1f} s; scan and session "
        f"statements clean (warm: no capture, build or compile; no "
        f"unbudgeted allocation), no leak at Cluster.stop, no race; "
        f"q33 over pgwire disarmed {med_d * 1e3:.2f} ms, armed "
        f"{med_a * 1e3:.2f} ms")
    assert out["seconds"] < SANITIZE_BUDGET_S, out["seconds"]
    return out


# ---------------- phase 12: chaos and the timeline ----------------

#: phase 12's time limit, seconds of script time
CHAOS_BUDGET_S = 120.0
#: seed of every phase-12 scenario
CHAOS_SEED = 42
#: the phase's timeline ring (a cold SF-10 Q1 records a few thousand
#: events; none may drop)
TIMELINE_EVENTS = 1 << 18
#: the timeline's per-stage event sums against StageTimer's stage
#: seconds (the reference's acceptance tolerance)
TIMELINE_REL = 0.10
#: kernelbench on the card: the group-by at the main path's shape, the
#: overhead A/Bs on warm Q1 at SF-1 (interleaved rounds, the order
#: turned each round; the chaos verdict counts and times the armed
#: sites, the profiling one takes the median same-round difference)
KB_ROWS = 1 << 20
KB_GROUPS = 1745
KB_AGGS = 4
KB_SF = 1.0
KB_ITERS = 9
#: rounds of the profiling A/B, whose ring side holds the timeline's
#: verdict: a warm SF-1 Q1's host time moves 10% between rounds on the
#: H100 machine (scripts/overhead_noise.py), so the median same-round
#: difference needs tens of rounds to resolve its 3% + 2 ms band (the
#: profiling verdict counts and times the trace work instead)
KB_PROFILE_ITERS = 45
KB_BLOCK_ROWS = 1 << 18
#: the reference's budgets (ydb_tpu/obs/kernelbench.py): chaos armed
#: within 1% of disarmed (its real-size call), profiling on within the
#: 2% default-on budget its docstring names (the timeline ring then
#: within max(3%, that) + 2 ms of profiling on)
KB_CHAOS_BUDGET = 0.01
KB_PROFILE_BUDGET = 0.02


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class chaos_armed:
    """A seeded scenario armed for a block (``CHAOS_FORCE`` pinned
    open), disarmed after; ``counters`` holds the snapshot taken at the
    end of the block."""

    def __init__(self, sites, seed=CHAOS_SEED, scenario=None):
        from ydb_tpu_torch import chaos

        self.scenario = scenario or chaos.Scenario(seed=seed, sites=sites)
        self.counters: dict = {}

    def __enter__(self):
        from ydb_tpu_torch import chaos

        self.saved = chaos.CHAOS_FORCE
        chaos.CHAOS_FORCE = True
        chaos.install(self.scenario)
        return self

    def __exit__(self, *exc):
        from ydb_tpu_torch import chaos

        self.counters = chaos.counters_snapshot()
        chaos.clear()
        chaos.CHAOS_FORCE = self.saved
        return False


def timeline_scans(dev, li, hits, answers) -> list:
    """Phase 12, timeline: a cold and a warm Q1 from the lineitem shard
    and a warm q33 from the hits shard, each profiled with the timeline
    forced on (the caller's ring); per query the events, drops, busy and
    fraction per stage, ``movement|compute``, and the timeline's stage
    sums against ``StageTimer``'s (within ``TIMELINE_REL``). Returns the
    rows and the cold Q1 result."""
    from ydb_tpu_torch.obs import profile as profile_mod
    from ydb_tpu_torch.obs import timeline, tracing
    from ydb_tpu_torch.obs.probes import StageTimer
    from ydb_tpu_torch.workload import clickbench, tpch

    rows, results = [], {}
    # one tracer for the three queries: trace ids are unique per tracer
    tracer = tracing.Tracer()

    def traced(label, shard, prog):
        ring = timeline.RING
        rec0, drop0 = ring.recorded, ring.dropped
        t0 = time.perf_counter()
        with profile_mod.profiled(label, tracer=tracer) as h:
            res = shard.scan(prog)
        _sync(dev)
        seconds = time.perf_counter() - t0
        p = h.profile
        evs = [e for e in ring.events() if e.trace_id == p.trace_id]
        sums = {c: sum(e.end - e.start for e in evs if e.cat == c)
                for c in StageTimer.STAGES}
        occ = p.stage_occupancy
        row = {"query": label, "seconds": seconds,
               "events": len(evs), "events_recorded": ring.recorded - rec0,
               "events_dropped": ring.dropped - drop0,
               "wall_s": occ.get("wall_seconds"),
               "busy_s": occ.get("busy"), "fraction": occ.get("fraction"),
               "movement_compute": occ.get("overlap", {}).get(
                   "movement|compute"),
               "stage_s": dict(p.stages), "event_stage_s": sums,
               "resident_rows": shard.last_scan_resident["rows"]}
        emit({"timeline_query": row})
        assert row["events_dropped"] == 0, row
        for c, total in p.stages.items():
            if total > 0:
                assert abs(sums[c] - total) <= TIMELINE_REL * total, \
                    (label, c, sums[c], total)
        assert row["movement_compute"] is not None, row
        rows.append(row)
        return res

    q1 = tpch.q1_program()
    li.resident.clear()
    li.block_cache.clear()
    results["q1"] = traced("q1_cold", li, q1)
    check_q1(results["q1"], answers["q1"])
    if li.resident.enabled():
        rows[-1]["resident_fill_after_s"] = fill_resident(li)
    identical(traced("q1_warm", li, q1), results["q1"], "q1 warm")
    if hits.resident.enabled():
        fill_resident(hits)
    q33 = clickbench.q33_program()
    hits.scan(q33)  # compile outside the recorded window
    res = traced("q33_warm", hits, q33)
    got = list(zip(hits.dicts["URL"].decode(res.cols["URL"][0]),
                   (int(x) for x in res.cols["c"][0])))
    assert got == answers["q33"], got[:3]
    return rows, results["q1"]


def blob_faults(dev, li, want1) -> dict:
    """Phase 12, chaos: ``blob.get_range`` ``io_error`` at p=0.05 on cold
    Q1 and Q6 lineitem scans (resident tier off, block cache cleared):
    each result bit-identical to the unfaulted one, the retries
    counted."""
    from ydb_tpu_torch.workload import tpch

    out = {}
    want = {"q1": want1, "q6": li.scan(tpch.q6_program())}
    for name, prog in (("q1", tpch.q1_program()),
                       ("q6", tpch.q6_program())):
        with toggles(resident=False):
            li.block_cache.clear()
            t0 = time.perf_counter()
            with chaos_armed({"blob.get_range": {"kind": "io_error",
                                                 "p": 0.05}}) as arm:
                res = li.scan(prog)
                _sync(dev)
            seconds = time.perf_counter() - t0
        identical(res, want[name], f"{name} under blob.get_range faults")
        site = arm.counters["sites"]["blob.get_range"]
        out[name] = {"seconds": seconds, "hits": site["hits"],
                     "fired": site["fired"],
                     "retries": arm.counters.get("retries", {}),
                     "chunks_read": li.last_scan_pruning["chunks_read"]}
    assert sum(r["fired"] for r in out.values()) > 0, out
    assert sum(sum(r["retries"].values()) for r in out.values()) \
        == sum(r["fired"] for r in out.values()), out
    return out


def resident_faults(dev, ck, hits) -> dict:
    """Phase 12, chaos: ``resident.lookup`` faults on q33 and q36 from the
    hits shard, on the fused and the per-aggregate lowering: each result
    bit-identical to the unfaulted one, the kernels' launches counted
    over the faulted scans (both must launch), one faulted scan under
    memsan (no unbudgeted allocation); then every kernel call of the same
    four faulted scans held against its plain version (not counted)."""
    from ydb_tpu_torch.analysis import memsan
    from ydb_tpu_torch.ssa import kernels
    from ydb_tpu_torch.workload import clickbench

    progs = {"q33": clickbench.q33_program(),
             "q36": clickbench.q36_program()}
    cases = [(n, low) for n in progs for low in ("fused", "peragg")]
    sites = {"resident.lookup": {"kind": "io_error", "p": 0.5}}

    def scan(name, lowering):
        kernels.FUSED_FORCE = lowering == "fused"
        try:
            return hits.scan(progs[name])
        finally:
            kernels.FUSED_FORCE = None

    want = {c: scan(*c) for c in cases}
    cuda = dev.type == "cuda"
    if cuda:
        ck.reset_launches()
    out = {"scans": []}
    with chaos_armed(sites) as arm:
        for c in cases:
            t0 = time.perf_counter()
            res = scan(*c)
            _sync(dev)
            identical(res, want[c], f"{c} under resident.lookup faults")
            out["scans"].append({
                "query": c[0], "lowering": c[1],
                "seconds": time.perf_counter() - t0,
                "resident_portions": hits.last_scan_resident["portions"]})
    if cuda:
        # the phase's main path launches, read before the check's own
        out["launches"] = dict(ck.LAUNCHES)
        assert all(v > 0 for v in out["launches"].values()), \
            out["launches"]
    out["lookup"] = arm.counters["sites"]["resident.lookup"]
    out["fallbacks"] = arm.counters["fallbacks"]["resident.lookup"]
    assert out["fallbacks"] == out["lookup"]["fired"] > 0, out
    hits.resident.drain(timeout=300)
    with chaos_armed(sites), memsan.activate():
        st = memsan.begin_statement("q33_resident_faults")
        res = scan("q33", "fused")
        out["memsan"] = memsan.end_statement(st, enforce=False)
    identical(res, want[("q33", "fused")], "q33 under memsan")
    assert out["memsan"]["unbudgeted"] == 0, out["memsan"]
    hits.resident.drain(timeout=300)
    if cuda:
        out["kernel_check"] = {}
        with chaos_armed(sites):
            for c in cases:
                got = checked_kernel_calls(ck, lambda c=c: scan(*c))
                k = "grouped_sum_multi" if c[1] == "fused" else "grouped_sum"
                assert got[k]["calls"] > 0, (c, got)
                out["kernel_check"]["_".join(c)] = got
        hits.resident.drain(timeout=300)
    return out


def worker_death() -> dict:
    """Phase 12, chaos: ``conveyor.task`` ``worker_death`` (budget 1) on a
    conveyor of two workers: the task errors typed, the pool respawns to
    two live workers, later tasks run, and ``wait_idle`` drains to depth
    0 (the shared scan conveyor too)."""
    from ydb_tpu_torch import chaos
    from ydb_tpu_torch.runtime.conveyor import Conveyor, shared_conveyor

    conv = Conveyor(workers=2)
    try:
        with chaos_armed({"conveyor.task": {"kind": "worker_death",
                                            "budget": 1}}) as arm:
            h = conv.submit("bg", lambda: 1)
            try:
                h.wait(timeout=30.0)
                raise AssertionError("the injected worker death did not "
                                     "fail its task")
            except chaos.ChaosError as e:
                error = str(e)
        t0 = time.perf_counter()
        while sum(t.is_alive() for t in conv._threads) < 2:
            assert time.perf_counter() - t0 < 10.0, "the pool did not heal"
            time.sleep(0.01)
        hs = [conv.submit("bg", lambda i=i: i * i) for i in range(8)]
        assert [h.wait(timeout=30.0) for h in hs] == [i * i for i in
                                                       range(8)]
        conv.wait_idle(timeout=30.0)
        depth = conv.queue_stats()["depth"]
    finally:
        conv.shutdown()
    shared_conveyor().wait_idle(timeout=60.0)
    shared = shared_conveyor().queue_stats()
    assert depth == shared["depth"] == shared["active"] == 0
    return {"error": error, "fired": arm.counters["sites"][
        "conveyor.task"]["fired"], "workers_alive": 2, "depth": depth}


def _rows_of(res):
    cols = [(f.name, 701 if f.type.is_floating else 0)
            for f in res.schema.fields]
    return wire_rows(res), cols


def cluster_faults(dev, cluster, srv, want, timeline_ring) -> dict:
    """Phase 12, chaos through the serving plane of a Cluster booted from
    phase 10's store: ``fuse.trace`` on fused q33, then one warm fused q33
    with the timeline on (its ``plan.dispatch`` interval lands in
    ``timeline_ring``); ``session.admit`` ``overload``; the noisy
    neighbor scenario over pgwire behind two tenants; the deadline
    scenario over Q1/Q3/Q6."""
    from ydb_tpu_torch import chaos, serving
    from ydb_tpu_torch.chaos.deadline import StatementCancelled
    from ydb_tpu_torch.kqp.rm import OverloadedError
    from ydb_tpu_torch.obs import timeline
    from ydb_tpu_torch.workload import clickbench
    from ydb_tpu_torch.workload.queries import TPCH

    out = {}
    s = cluster.session()
    q33 = clickbench.QUERIES["q33"]
    # fuse.trace: the walk answers, then one clean capture follows
    with chaos_armed({"fuse.trace": {"kind": "io_error",
                                     "budget": 1}}) as arm, \
            routed() as seen:
        walked = s.execute(q33)
        fused = s.execute(q33)
    assert seen == ["fused"], seen  # the first statement was walked
    plans = _fused_in(cluster)
    got, cols = _rows_of(walked)
    same_wire(got, want["q33"], cols, "q33 walked after fuse.trace")
    same_wire(_rows_of(fused)[0], want["q33"], cols, "q33 fused")
    out["fuse_trace"] = {
        "fired": arm.counters["sites"]["fuse.trace"]["fired"],
        "fallbacks": arm.counters["fallbacks"]["fuse.trace"],
        "captures": sum(p.captures for p in plans) if dev.type == "cuda"
        else None}
    if dev.type == "cuda":
        assert out["fuse_trace"]["captures"] == 1, out["fuse_trace"]
    # the timeline's dispatch events: one warm fused statement
    prev = timeline.TIMELINE_FORCE
    timeline.TIMELINE_FORCE = True
    try:
        with routed() as seen:
            same_wire(_rows_of(s.execute(q33))[0], want["q33"], cols,
                      "q33 warm fused, timeline on")
        assert seen == ["fused"], seen
        p = s.last_profile
        out["fused_timeline"] = {
            "dispatch_events": sum(
                1 for e in timeline_ring.events()
                if e.cat == "dispatch" and e.trace_id == p.trace_id),
            "occupancy": p.stage_occupancy}
    finally:
        timeline.TIMELINE_FORCE = prev
    if dev.type == "cuda":
        assert out["fused_timeline"]["dispatch_events"] == 1, out
    # session.admit overload: a typed shed
    with chaos_armed({"session.admit": {"kind": "overload",
                                        "budget": 1}}):
        try:
            s.execute(q33)
            raise AssertionError("session.admit overload did not shed")
        except OverloadedError as e:
            out["session_admit"] = {"error": type(e).__name__,
                                    "message": str(e),
                                    "error_reason":
                                    s.last_profile.error_reason}
    assert out["session_admit"]["error_reason"] == "overloaded"
    # noisy neighbor: two tenants over pgwire under the shipped scenario
    reg = serving.TenantRegistry()
    reg.register("gold", weight=3.0, max_inflight=4, queue_size=8)
    reg.register("bronze", weight=1.0, max_inflight=1, queue_size=0)
    fd = serving.install(cluster, reg)
    path = os.path.join(HERE, "ydb_tpu_torch", "chaos",
                        "noisy_neighbor.json")
    q36 = clickbench.QUERIES["q36"]
    try:
        with chaos_armed(None, scenario=chaos.Scenario.from_file(path)) \
                as arm:
            gold, _ = concurrent_queries(srv.port, [[q33, q36]] * 4,
                                         startup={"tenant": "gold"})
            bronze, _ = concurrent_queries(srv.port, [[q36]] * 6,
                                           startup={"tenant": "bronze"})
        answered = shed = 0
        for st in gold + bronze:
            if st[4]:
                assert all("bronze" in e for e in st[4]), st[4]
                shed += 1
                continue
            name = "q33" if st[1] == q33 else "q36"
            same_wire(st[2], want[name], st[3], f"{name} noisy neighbor",
                      rtol=1e-12)
            answered += 1
        snap = fd.snapshot()
    finally:
        cluster.front_door = None
        cluster.workload = None
    assert all(not st[4] for st in gold), "a gold statement was shed"
    out["noisy_neighbor"] = {
        "answered": answered, "shed": shed,
        "gold_admitted": snap["gold"]["admitted"],
        "bronze_shed": snap["bronze"]["shed"],
        "sites": {k: v["fired"] for k, v in arm.counters["sites"].items()}}
    # the deadline scenario: blob faults at p=0.05 on cold reads, a
    # fifth of the statements past their deadline
    queries = {k: TPCH[k] for k in ("q1", "q3", "q6")}
    cancelled = stmt = 0
    with chaos_armed({"blob.get_range": {"kind": "io_error",
                                         "p": 0.05}}) as arm:
        for _ in range(2):
            for name, sql in queries.items():
                stmt += 1
                cluster.scan_block_cache.clear()
                if stmt % 5 == 0:
                    try:
                        s.execute(sql, timeout=0.0)
                        raise AssertionError(f"{name} past its deadline "
                                             f"answered")
                    except StatementCancelled:
                        cancelled += 1
                    assert s.last_profile.error_reason == "cancelled"
                else:
                    got, cols = _rows_of(s.execute(sql, timeout=120.0))
                    same_wire(got, want[name], cols, f"{name} deadline "
                              f"scenario", rtol=1e-12)
    out["deadline"] = {"statements": stmt, "cancelled": cancelled,
                       "blob_hits": arm.counters["sites"][
                           "blob.get_range"]["hits"],
                       "blob_fired": arm.counters["sites"][
                           "blob.get_range"]["fired"],
                       "retries": arm.counters.get("retries", {})}
    assert cancelled == 1, out["deadline"]
    return out


def kernelbench_on_card(dev, ck) -> dict:
    """Phase 12, kernelbench: the group-by at 1<<20 rows and 1,745 groups
    on both lowerings against the CPU oracle (each kernel must launch),
    and the chaos and profiling overheads on warm Q1 at SF-1 (one shard
    for both) within the reference's budgets."""
    from ydb_tpu_torch.obs import kernelbench
    from ydb_tpu_torch.workload import tpch

    out = {}
    before = dict(ck.LAUNCHES) if dev.type == "cuda" else {}
    out["group_by"] = kernelbench.bench_group_by(
        KB_ROWS, KB_GROUPS, KB_AGGS, 3, device=dev)
    if dev.type == "cuda":
        out["group_by"]["launches"] = {k: ck.LAUNCHES[k] - before[k]
                                       for k in before}
        assert all(v > 0 for v in out["group_by"]["launches"].values()), \
            out["group_by"]
    shard = kernelbench.lineitem_shard(
        "kb", KB_SF, KB_BLOCK_ROWS, dev, tpch.TpchData(sf=KB_SF, seed=5))
    out["chaos_overhead"] = kernelbench.bench_chaos_overhead(
        KB_SF, KB_ITERS, KB_BLOCK_ROWS, assert_within=KB_CHAOS_BUDGET,
        device=dev, shard=shard)
    out["profile_overhead"] = kernelbench.bench_profile_overhead(
        KB_SF, KB_PROFILE_ITERS, KB_BLOCK_ROWS,
        assert_within=KB_PROFILE_BUDGET, device=dev, shard=shard)
    return out


def chaos_phase(dev, ck, storage_root, serving_root, answers, want) -> dict:
    """Phase 12 (see the module docstring). ``storage_root`` holds phase
    9's lineitem and hits shards, ``serving_root`` phase 10's store,
    ``answers`` the numpy Q1 and the q33 answer, ``want`` phase 10's
    unsanitized wire rows of Q1, Q3, Q6, q33 and q36."""
    from ydb_tpu_torch.analysis import leaksan
    from ydb_tpu_torch.engine.blobs import DirBlobStore
    from ydb_tpu_torch.engine.shard import ColumnShard
    from ydb_tpu_torch.obs import timeline
    from ydb_tpu_torch.runtime.conveyor import shared_conveyor
    from ydb_tpu_torch.workload import clickbench, tpch

    t_phase = time.perf_counter()
    out: dict = {}
    steps: dict = {}
    t_step = [t_phase]

    def step(name):
        now = time.perf_counter()
        steps[name] = round(now - t_step[0], 3)
        t_step[0] = now

    store = DirBlobStore(storage_root)
    li = ColumnShard.boot("li", tpch.LINEITEM_SCHEMA, store,
                          config=storage_config(), device=dev)
    hits = ColumnShard.boot("hits", clickbench.HITS_SCHEMA, store,
                            config=storage_config(), device=dev)
    out["boot_s"] = time.perf_counter() - t_phase
    step("boot")
    ring = timeline.TimelineRing(TIMELINE_EVENTS, "phase12")
    saved = (timeline.RING, timeline.TIMELINE_FORCE)
    timeline.RING = ring
    try:
        timeline.TIMELINE_FORCE = True
        try:
            out["timeline"], q1_result = timeline_scans(dev, li, hits,
                                                        answers)
        finally:
            timeline.TIMELINE_FORCE = saved[1]
        step("timeline")
        out["blob"] = blob_faults(dev, li, q1_result)
        step("blob")
        out["resident"] = resident_faults(dev, ck, hits)
        step("resident")
        del li, hits
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["conveyor"] = worker_death()
        step("worker_death")
        with leaksan.activate():
            cluster, srv, out["cluster_boot_s"] = serving_boot(
                serving_root, dev)
            try:
                out["cluster"] = cluster_faults(dev, cluster, srv, want,
                                                ring)
                shared_conveyor().wait_idle(timeout=60.0)
                inflight = 0
                for t in cluster.tables.values():
                    for sh in t.shards:
                        sh.resident.drain(timeout=300)
                        inflight += sh.resident.snapshot()["inflight"]
                out["leaks_before_stop"] = leaksan.counts()
            finally:
                srv.stop()
                cluster.stop()  # raises LeakError when a handle outlived it
            out["leaks_at_stop"] = leaksan.counts()
            out["promotion_flights"] = inflight
        step("cluster")
        assert out["leaks_before_stop"] == out["leaks_at_stop"] == {}, out
        assert inflight == 0
        trace = timeline.export_chrome_trace(ring=ring)
        path = os.path.join(HERE, "build", "phase12_trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f)
        cats = collections.Counter(e["cat"] for e in trace["traceEvents"]
                                   if e["ph"] == "X")
        out["trace"] = {"path": os.path.relpath(path, HERE),
                        "events": sum(cats.values()),
                        "categories": dict(sorted(cats.items())),
                        "dropped": ring.dropped}
        need = {"read", "stage", "compute", "blob.read", "decode", "span",
                "conveyor.wait", "conveyor.run"}
        if dev.type == "cuda":
            need.add("dispatch")
        assert need <= set(cats), (need, cats)
        assert ring.dropped == 0, ring.dropped
    finally:
        timeline.RING, timeline.TIMELINE_FORCE = saved
    step("trace")
    out["kernelbench"] = kernelbench_on_card(dev, ck)
    step("kernelbench")
    out["seconds"] = time.perf_counter() - t_phase
    res = out["resident"]
    emit({"timeline": {
        "queries": out["timeline"], "trace": out["trace"],
        "fused_dispatch": out["cluster"]["fused_timeline"]}})
    emit({"chaos": {
        "seed": CHAOS_SEED, "blob_get_range": out["blob"],
        "resident_lookup": {k: res[k] for k in (
            "scans", "lookup", "fallbacks", "memsan") if k in res},
        "launches": res.get("launches"),
        "fuse_trace": out["cluster"]["fuse_trace"],
        "worker_death": out["conveyor"],
        "session_admit": out["cluster"]["session_admit"],
        "noisy_neighbor": out["cluster"]["noisy_neighbor"],
        "deadline": out["cluster"]["deadline"],
        "leaks_at_stop": out["leaks_at_stop"],
        "promotion_flights": out["promotion_flights"],
        "steps_s": steps, "seconds": out["seconds"]}})
    emit({"kernelbench": out["kernelbench"]})
    log(f"chaos phase: {out['seconds']:.1f} s (steps {steps}); "
        f"faulted Q1/Q6/q33/q36 "
        f"bit-identical to unfaulted; no leak, no stranded promotion; "
        f"chaos overhead "
        f"{out['kernelbench']['chaos_overhead']['overhead_pct']}%, "
        f"profiling "
        f"{out['kernelbench']['profile_overhead']['overhead_pct']}%")
    assert out["seconds"] < CHAOS_BUDGET_S, out["seconds"]
    return out


# ---------------- phase 14: monitoring, coordination and load ----------------

#: phase 14's own time limit, seconds of script time
MONITOR_BUDGET_S = 60.0
#: seconds of the 8-connection load under which the ninth polls
MONITOR_LOAD_S = 10.0
MONITOR_CLIENTS = 8
#: requests of each LoadService kind
LOAD_REQUESTS = 200
LOAD_SEED = 7
#: connections inserting with nextval, and rows each
SEQ_CLIENTS = 4
SEQ_ROWS = 50
#: the quoter's kqp/requests bucket, and statements sent back to back
QUOTER_BURST = 5.0
QUOTER_RATE = 1.0
QUOTER_STATEMENTS = 60
#: per view, the columns whose values move between two back-to-back reads
#: (process and device memory); the rest must be equal
MONITOR_VOLATILE = {
    "sys_memory": {"value"},
    "sys_device_memory": {"live_bytes", "peak_bytes", "charges",
                          "releases", "evictions"},
}


def http_json(port, path):
    """GET ``path`` off the viewer: (parsed JSON, milliseconds)."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        body = r.read()
    return json.loads(body), (time.perf_counter() - t0) * 1e3


def monitor_load(srv, viewer, want) -> dict:
    """Step 3: ``MONITOR_CLIENTS`` connections loop over q33 and q3 for
    ``MONITOR_LOAD_S``, every answer equal to phase 10's; meanwhile a
    ninth polls ``sys_active_queries`` over pgwire and the viewer's
    timeline. Each SQL poll must see its own statement; after the load
    the view holds exactly the statement that reads it."""
    import threading

    from ydb_tpu_torch.workload import clickbench
    from ydb_tpu_torch.workload.queries import TPCH

    work = (("q33", clickbench.QUERIES["q33"]), ("q3", TPCH["q3"]))
    poll = "SELECT query_text, stage FROM sys_active_queries"
    stop = threading.Event()
    done, fail = [], []

    def loop(i):
        try:
            cl = PgClient(srv.port)
            n = 0
            while not stop.is_set():
                name, sql = work[(i + n) % 2]
                got, cols = cl.ok(sql)
                same_wire(got, want[name], cols, f"{name} under load",
                          rtol=1e-12)
                n += 1
            cl.close()
            done.append(n)
        except Exception as e:  # noqa: BLE001 - raised below
            fail.append(e)

    threads = [threading.Thread(target=loop, args=(i,))
               for i in range(MONITOR_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    pc = PgClient(srv.port)
    polls, seen, tl_seen, poll_ms, tl_ms = 0, [], [], [], []
    while time.perf_counter() - t0 < MONITOR_LOAD_S and not fail:
        ts = time.perf_counter()
        rows, _cols = pc.ok(poll)
        poll_ms.append((time.perf_counter() - ts) * 1e3)
        texts = [r[0].decode() for r in rows]
        assert poll in texts, texts
        seen.append(len(rows))
        tl, ms = http_json(viewer.port, "/viewer/json/timeline")
        tl_ms.append(ms)
        assert isinstance(tl["active_queries"], list), tl
        tl_seen.append(len(tl["active_queries"]))
        polls += 1
    stop.set()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if fail:
        raise fail[0]
    rows, _ = pc.ok(poll)
    assert [r[0].decode() for r in rows] == [poll], rows
    pc.close()
    out = {"seconds": wall, "statements": sum(done), "polls": polls,
           "max_active_seen": max(seen), "max_timeline_active": max(tl_seen),
           "poll_ms_median": statistics.median(poll_ms),
           "timeline_ms_median": statistics.median(tl_ms),
           "statements_per_s": sum(done) / wall}
    emit({"monitor_load": out})
    return out


def view_rows_equal(name, schema, wire, cols, http) -> None:
    """A sys view read over pgwire (text DataRows) and through the viewer
    (JSON rows): equal in every column but ``MONITOR_VOLATILE``'s."""
    from ydb_tpu_torch.api.pgwire import _format_value

    skip = MONITOR_VOLATILE.get(name, set())
    names = [c for c, _oid in cols]
    assert names == list(schema.names), (name, names)
    assert len(wire) == len(http), (name, len(wire), len(http))
    for r, (w, h) in enumerate(zip(wire, http)):
        for f, wv in zip(schema.fields, w):
            if f.name in skip:
                continue
            hv = h[f.name]
            want = (hv.encode() if f.type.is_string
                    else _format_value(f.type.kind, f.type.scale, hv))
            assert wv == want, (name, r, f.name, wv, hv)


def monitor_views(cluster, srv, viewer, dev, tables, tpch_rows) -> dict:
    """Step 4: every sys view through the viewer and then over pgwire
    (nothing runs between the two reads), equal but for the volatile
    columns; ``sys_active_queries`` over pgwire holds its own statement,
    which the viewer's read (no statement) does not. Then the row counts
    (each TPC-H table's equal to ``tpch_rows``, the rows phase 10
    generated), the top query, device memory under memsan, health and
    the Prometheus page."""
    from ydb_tpu_torch.analysis import memsan
    from ydb_tpu_torch.obs import sysview
    from ydb_tpu_torch.workload import clickbench

    # promotions that the load started settle first: the resident view's
    # counters must not move between its two reads
    for t in cluster.tables.values():
        for sh in t.shards:
            if getattr(sh, "resident", None) is not None:
                sh.resident.drain()
    cl = PgClient(srv.port)
    out: dict = {"views": {}}

    def both(name):
        t0 = time.perf_counter()
        src = sysview.sys_source(cluster, name)
        build_ms = (time.perf_counter() - t0) * 1e3
        http, http_ms = http_json(viewer.port,
                                  f"/viewer/json/sysview?name={name}")
        sql = f"SELECT * FROM {name}"
        t0 = time.perf_counter()
        wire, cols = cl.ok(sql)
        wire_ms = (time.perf_counter() - t0) * 1e3
        if name == "sys_active_queries":
            mine = [r for r in wire if r[0] == sql.encode()]
            assert len(mine) == 1, wire
            wire = [r for r in wire if r[0] != sql.encode()]
        view_rows_equal(name, sysview.SYS_SCHEMAS[name], wire, cols, http)
        out["views"][name] = {"rows": len(http), "build_ms": build_ms,
                              "endpoint_ms": http_ms, "pgwire_ms": wire_ms,
                              "build_rows": src.num_rows}
        return http

    views = {name: both(name) for name in sysview.SYS_SCHEMAS
             if name != "sys_device_memory"}
    # row counts: partitions, table statistics and COUNT(*) agree
    parts: dict = collections.Counter()
    for r in views["sys_partition_stats"]:
        parts[r["table_name"]] += r["rows"]
    stats = {r["table_name"]: r["rows"] for r in views["sys_table_stats"]}
    assert set(parts) == set(stats) == set(tables), (parts, stats)
    counts = {}
    for t in tables:
        rows, _ = cl.ok(f"SELECT count(*) AS n FROM {t}")
        counts[t] = int(rows[0][0])
        assert parts[t] == stats[t] == counts[t], (t, parts[t], stats[t],
                                                   counts[t])
    for t, n in tpch_rows.items():
        assert counts[t] == n, (t, counts[t], n)
    out["row_counts"] = counts
    out["tpch_rows"] = sum(counts[t] for t in tpch_rows)
    # the most expensive retained statement is at least as slow as every
    # statement of the log (both read off the viewer, back to back)
    top, _ = http_json(viewer.port, "/viewer/json/sysview?name="
                       "sys_top_queries")
    qlog, _ = http_json(viewer.port, "/viewer/json/sysview?name="
                        "sys_query_log")
    first = next(r for r in top if r["rank"] == 1)
    assert all(first["seconds"] >= r["seconds"] for r in qlog), first
    out["top_query"] = {"query_text": first["query_text"][:80],
                        "seconds": first["seconds"]}
    # device memory: memsan armed for one q33, the view read both ways;
    # the allocator's peak is read from a reset before it
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with memsan.activate():
        cl.ok(clickbench.QUERIES["q33"])
        dm = both("sys_device_memory")
        if cuda:
            torch.cuda.synchronize(dev)
    allocator_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    glob = next(r for r in dm if r["component"] == "<global>")
    assert 0 <= glob["live_bytes"] <= glob["peak_bytes"], glob
    assert not cuda or glob["peak_bytes"] <= allocator_peak, \
        (glob, allocator_peak)
    out["device_memory"] = {"components": [r["component"] for r in dm],
                            "global_live_bytes": glob["live_bytes"],
                            "global_peak_bytes": glob["peak_bytes"],
                            "allocator_peak_bytes": allocator_peak}
    assert http_json(viewer.port, "/viewer/json/healthcheck")[0] == {
        "status": "GOOD", "issues": []}
    # the Prometheus page parses: every sample line is name{labels} value
    import urllib.request

    with urllib.request.urlopen(
            f"http://127.0.0.1:{viewer.port}/counters/prometheus",
            timeout=60) as r:
        prom = r.read().decode()
    samples = 0
    for line in prom.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        float(value)
        assert name and (name.count("{") == name.count("}")), line
        samples += 1
    assert samples > 0
    out["prometheus_samples"] = samples
    cl.close()
    emit({"monitor_views": out})
    return out


def monitor_loadservice(cluster) -> dict:
    """Step 5: the load service's three kinds at ``LOAD_REQUESTS``."""
    from ydb_tpu_torch.obs.loadtest import LoadService

    svc = LoadService(cluster, seed=LOAD_SEED)
    out = {}
    for kind in ("kv_upsert", "select", "storage_put"):
        r = svc.run(kind, requests=LOAD_REQUESTS)
        assert r["requests"] == LOAD_REQUESTS and r["errors"] == 0, r
        assert 0 < r["p50_ms"] <= r["p90_ms"] <= r["p99_ms"], r
        out[kind] = r
    emit({"monitor_loadservice": out})
    return out


def monitor_sequences(srv) -> dict:
    """Step 6, first part: ``CREATE SEQUENCE`` over pgwire, then
    ``SEQ_CLIENTS`` connections each INSERT ``SEQ_ROWS`` rows with
    ``nextval`` into a row table; every value distinct."""
    import threading

    cl = PgClient(srv.port)
    cl.ok("CREATE SEQUENCE mon_seq START 1 CACHE 16")
    cl.ok("CREATE TABLE mon_ids (id int64, w int64, PRIMARY KEY (id)) "
          "WITH (store = row)")
    fail = []

    def insert(i):
        try:
            c = PgClient(srv.port)
            for j in range(SEQ_ROWS):
                c.ok(f"INSERT INTO mon_ids VALUES (nextval('mon_seq'), "
                     f"{i * SEQ_ROWS + j})")
            c.close()
        except Exception as e:  # noqa: BLE001 - raised below
            fail.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=insert, args=(i,))
               for i in range(SEQ_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    insert_s = time.perf_counter() - t0
    if fail:
        raise fail[0]
    rows, _ = cl.ok("SELECT id FROM mon_ids")
    cl.close()
    ids = sorted(int(r[0]) for r in rows)
    assert len(ids) == len(set(ids)) == SEQ_CLIENTS * SEQ_ROWS, len(ids)
    return {"values": len(ids), "min": ids[0], "max": ids[-1],
            "insert_s": insert_s, "inserts_per_s": len(ids) / insert_s}


def monitor_sequences_rebooted(srv, seq) -> None:
    """Step 6, second part, on a Cluster booted again from the same
    directory: ``nextval`` hands out a value above every one before; after
    ``DROP SEQUENCE`` it raises the reference's error."""
    cl = PgClient(srv.port)
    cl.ok("INSERT INTO mon_ids VALUES (nextval('mon_seq'), -1)")
    rows, _ = cl.ok("SELECT id FROM mon_ids WHERE w = -1")
    seq["after_reboot"] = int(rows[0][0])
    assert seq["after_reboot"] > seq["max"], seq
    rows, _ = cl.ok("SELECT count(*) AS n FROM mon_ids")
    assert int(rows[0][0]) == seq["values"] + 1, rows
    cl.ok("DROP SEQUENCE mon_seq")
    _rows, _cols, _tags, errors = cl.query(
        "INSERT INTO mon_ids VALUES (nextval('mon_seq'), -2)")
    assert len(errors) == 1 and "no sequence mon_seq" in errors[0], errors
    seq["after_drop"] = errors[0]
    cl.close()
    emit({"monitor_sequences": seq})


def monitor_quoter(cluster, srv) -> dict:
    """Step 7: a ``Quoter`` with ``kqp/requests`` at ``QUOTER_BURST`` and
    ``QUOTER_RATE``; ``QUOTER_STATEMENTS`` statements back to back over
    one connection. The admitted ones are at most the burst plus the rate
    times the elapsed seconds, plus one; the rest raise ``ThrottledError``
    and the ``throttled`` counter counts them."""
    from ydb_tpu_torch.runtime.quoter import Quoter

    g = cluster.counters.group(kind="throttled").counter("queries")
    before = g.value
    q = Quoter()
    q.configure("kqp/requests", rate=QUOTER_RATE, burst=QUOTER_BURST)
    cl = PgClient(srv.port)
    cluster.quoter = q
    admitted = throttled = 0
    try:
        t0 = time.perf_counter()
        for _ in range(QUOTER_STATEMENTS):
            _rows, _cols, _tags, errors = cl.query(
                "SELECT count(*) AS n FROM mon_ids")
            if errors:
                assert errors == ["request rate limit exceeded"], errors
                throttled += 1
            else:
                admitted += 1
        elapsed = time.perf_counter() - t0
    finally:
        cluster.quoter = None
    cl.ok("SELECT count(*) AS n FROM mon_ids")
    cl.close()
    limit = QUOTER_BURST + QUOTER_RATE * elapsed + 1
    out = {"statements": QUOTER_STATEMENTS, "admitted": admitted,
           "throttled": throttled, "elapsed_s": elapsed, "limit": limit,
           "throttled_counter": g.value - before}
    emit({"monitor_quoter": out})
    assert QUOTER_BURST <= admitted <= limit, out
    assert throttled > 0 and throttled == g.value - before, out
    return out


def monitor_phase(dev, ck, root, want, tpch_rows) -> dict:
    """Phase 14 (see the module docstring). ``root`` is phase 10's store,
    ``want`` the wire rows of ``sanitize_statements()`` there,
    ``tpch_rows`` the rows of each TPC-H table phase 10 loaded. On the
    CPU (a rehearsal) no kernel is counted or checked."""
    from ydb_tpu_torch.obs.viewer import Viewer
    from ydb_tpu_torch.ssa import kernels

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {}
    cluster, srv, out["boot_s"] = serving_boot(root, dev)
    viewer = Viewer(cluster, port=0).start()
    try:
        tables = sorted(cluster.tables)
        # step 2: the statements, counted; q33 and q36 also on the
        # per-aggregate lowering, so both kernels are on the path
        stmts = sanitize_statements()
        cl = PgClient(srv.port)
        if cuda:
            ck.reset_launches()
        for name, sql in stmts.items():
            got, cols = cl.ok(sql)
            same_wire(got, want[name], cols, name, rtol=1e-12)
        cluster._invalidate_plans()
        kernels.FUSED_FORCE = False
        try:
            with fusion_force(False):
                for name in ("q33", "q36"):
                    got, cols = cl.ok(stmts[name])
                    same_wire(got, want[name], cols, name + "_peragg")
        finally:
            kernels.FUSED_FORCE = None
            cluster._invalidate_plans()
        cl.close()
        if cuda:
            out["launches"] = dict(ck.LAUNCHES)
            log(f"monitor launches (q1, q6, q3, q33, q36, then q33 and q36 "
                f"per-aggregate, over pgwire): {out['launches']}")
            assert all(v > 0 for v in out["launches"].values()), \
                out["launches"]
            out["kernel_check"] = serving_kernels(cluster, ck)
        # steps 3-5
        out["load"] = monitor_load(srv, viewer, want)
        out["views"] = monitor_views(cluster, srv, viewer, dev, tables,
                                     tpch_rows)
        out["loadservice"] = monitor_loadservice(cluster)
        # step 6: the sequence, then a reboot from the same directory
        seq = monitor_sequences(srv)
        viewer.stop()
        viewer = None
        srv.stop()
        cluster.stop()
        cluster = srv = None
        cluster, srv, seq["boot_s"] = serving_boot(root, dev)
        monitor_sequences_rebooted(srv, seq)
        out["sequences"] = seq
        # step 7
        out["quoter"] = monitor_quoter(cluster, srv)
    finally:
        if viewer is not None:
            viewer.stop()
        if srv is not None:
            srv.stop()
        if cluster is not None:
            cluster.stop()
    out["seconds"] = time.perf_counter() - t_phase
    views = out["views"]["views"]
    emit({"monitor": {
        "seconds": out["seconds"], "boot_s": out["boot_s"],
        "launches": out.get("launches"),
        "load": out["load"], "tpch_rows": out["views"]["tpch_rows"],
        "view_build_ms": {k: v["build_ms"] for k, v in views.items()},
        "view_endpoint_ms": {k: v["endpoint_ms"] for k, v in views.items()},
        "view_pgwire_ms": {k: v["pgwire_ms"] for k, v in views.items()},
        "view_rows": {k: v["rows"] for k, v in views.items()},
        "device_memory": out["views"]["device_memory"],
        "loadservice": {k: {m: v[m] for m in ("rps", "p50_ms", "p90_ms",
                                              "p99_ms")}
                        for k, v in out["loadservice"].items()},
        "sequences": out["sequences"], "quoter": out["quoter"]}})
    log(f"monitor phase: {out['seconds']:.1f} s; 15 sys views equal over "
        f"pgwire and the viewer, {out['views']['tpch_rows']} TPC-H rows "
        f"counted three ways, health GOOD, load service clean, "
        f"{out['sequences']['values']} distinct nextval values (reboot "
        f"{out['sequences']['boot_s']:.2f} s), quoter admitted "
        f"{out['quoter']['admitted']} of {out['quoter']['statements']}")
    assert out["seconds"] < MONITOR_BUDGET_S, out["seconds"]
    return out


# ---------------- phase 15: the gRPC front ----------------

#: phase 15's own time limit, seconds of script time
GRPC_BUDGET_S = 60.0
#: rows written by BulkUpsert and streamed back by ReadTable, and rows per
#: BulkUpsert call (gRPC's default 4 MiB message limit holds about 90,000
#: of these rows)
GRPC_UPSERT_ROWS = 100_000
GRPC_UPSERT_BATCH = 25_000
#: rows per ReadTable frame
GRPC_FRAME_ROWS = 16_384
GRPC_SEED = 15
#: seconds of the load, and its client threads (one Driver each)
GRPC_LOAD_S = 10.0
GRPC_CLIENTS = 8
#: the rate-limiter resource of step 5, and acquisitions sent back to back
GRPC_RL_RATE = 20.0
GRPC_RL_BURST = 5.0
GRPC_RL_CALLS = 100


def arrow_wire(table) -> tuple:
    """An Arrow result of the gRPC front as the text DataRows phase 10's
    pgwire server sends for the same values, and its (name, oid) columns
    (a float oid for float columns, so ``same_wire`` compares those within
    its tolerance; 0 for the rest)."""
    from ydb_tpu_torch import dtypes
    from ydb_tpu_torch.api.pgwire import _format_value
    from ydb_tpu_torch.blocks import DictionarySet
    from ydb_tpu_torch.blocks.arrow_bridge import (_column_to_numpy,
                                                   schema_from_arrow)

    floats = (dtypes.Kind.FLOAT, dtypes.Kind.DOUBLE)
    cols, names = [], []
    for f in schema_from_arrow(table.schema).fields:
        col = table.column(f.name).combine_chunks()
        if f.type.is_string:
            vals = [None if v is None else v.encode("utf-8", "surrogateescape")
                    for v in col.to_pylist()]
        else:
            phys, valid = _column_to_numpy(col, f, DictionarySet())
            vals = [_format_value(f.type.kind, f.type.scale, v) if ok else None
                    for v, ok in zip(phys.tolist(), valid.tolist())]
        cols.append(vals)
        names.append((f.name, _FLOAT_OIDS[-1] if f.type.kind in floats
                      else 0))
    return [list(r) for r in zip(*cols)], names


def grpc_boot(root, dev):
    """The node of phases 15 and 16: a Cluster booted from ``root`` behind
    ``make_server(cluster, port=0)`` (127.0.0.1), a port ``Driver`` to
    it, and the seconds the boot took; ``stop_node`` stops it."""
    from ydb_tpu_torch.api.client import Driver
    from ydb_tpu_torch.api.server import make_server
    from ydb_tpu_torch.config import AppConfig
    from ydb_tpu_torch.engine.blobs import DirBlobStore
    from ydb_tpu_torch.kqp.session import Cluster

    t0 = time.perf_counter()
    cluster = Cluster(store=DirBlobStore(root), device=dev,
                      config=AppConfig())
    srv, port = make_server(cluster, port=0)
    srv.start()
    return cluster, srv, port, Driver(f"127.0.0.1:{port}"), \
        time.perf_counter() - t0


def stop_node(node) -> None:
    cluster, srv, _port, drv, _boot_s = node
    drv.close()
    srv.stop(0)
    srv.request_proxy.close()
    cluster.stop()


def grpc_query(cluster, drv, ck, want, cuda) -> dict:
    """Step 2: the Query service. Launch counters zeroed; Q1, Q6, q3 (DQ),
    q33 and q36, then q33 and q36 on the per-aggregate lowering with
    fusion off, each Arrow result equal to phase 10's pgwire answer; both
    kernels must launch; then every kernel call of q33 and q36 is held
    against its plain version (``serving_kernels``; not counted)."""
    from ydb_tpu_torch.ssa import kernels

    stmts = sanitize_statements()
    q = drv.query_client()
    out: dict = {"statement_s": {}}
    if cuda:
        ck.reset_launches()
    for name, sql in stmts.items():
        t0 = time.perf_counter()
        rows, cols = arrow_wire(q.execute(sql))
        out["statement_s"][name] = time.perf_counter() - t0
        same_wire(rows, want[name], cols, f"grpc {name}", rtol=1e-12)
    cluster._invalidate_plans()
    kernels.FUSED_FORCE = False
    try:
        with fusion_force(False):
            for name in ("q33", "q36"):
                t0 = time.perf_counter()
                rows, cols = arrow_wire(q.execute(stmts[name]))
                out["statement_s"][name + "_peragg"] = \
                    time.perf_counter() - t0
                same_wire(rows, want[name], cols, f"grpc {name}_peragg")
    finally:
        kernels.FUSED_FORCE = None
        cluster._invalidate_plans()
    q.close()
    if cuda:
        out["launches"] = dict(ck.LAUNCHES)
        log(f"grpc launches (q1, q6, q3, q33, q36, then q33 and q36 "
            f"per-aggregate, over gRPC): {out['launches']}")
        assert all(v > 0 for v in out["launches"].values()), out["launches"]
        out["kernel_check"] = serving_kernels(cluster, ck)
    return out


def grpc_table(drv) -> dict:
    """Step 3: the Table service. ``CREATE TABLE``, a BulkUpsert of
    ``GRPC_UPSERT_ROWS`` rows as Arrow, ReadTable streamed back equal
    (and COUNT/SUM equal numpy); on a row table, an interactive
    transaction that commits, one that rolls back, and ``DeleteSession``
    with a transaction open rolling it back."""
    import datetime
    import decimal

    import pyarrow as pa

    from ydb_tpu_torch.api.client import ApiError

    out: dict = {}
    rng = np.random.default_rng(GRPC_SEED)
    n = GRPC_UPSERT_ROWS
    cents = rng.integers(-10**6, 10**8, n)
    days = rng.integers(8035, 10591, n).astype(np.int32)
    at = pa.table({
        "id": pa.array(rng.permutation(n).astype(np.int64)),
        "tag": pa.array([f"tag{i}" for i in rng.zipf(1.3, n) % 1000]),
        "v": pa.array(rng.standard_normal(n)),
        "amt": pa.array([decimal.Decimal(int(c)).scaleb(-2) for c in cents],
                        pa.decimal128(12, 2)),
        "d": pa.array(days, pa.date32()),
    })
    t = drv.table_client()
    t.create_table("grpc_ev", [("id", "int64", True),
                               ("tag", "string", False),
                               ("v", "float64", False),
                               ("amt", "decimal(12,2)", False),
                               ("d", "date", False)],
                   primary_key=["id"], store="column", shards=4)
    t0 = time.perf_counter()
    for lo in range(0, n, GRPC_UPSERT_BATCH):
        part = at.slice(lo, GRPC_UPSERT_BATCH)
        assert t.bulk_upsert("grpc_ev", part) == part.num_rows
    out["bulk_upsert_s"] = time.perf_counter() - t0
    out["bulk_upsert_rows_per_s"] = n / out["bulk_upsert_s"]
    t0 = time.perf_counter()
    frames = list(t.read_table("grpc_ev", batch_rows=GRPC_FRAME_ROWS))
    out["read_table_s"] = time.perf_counter() - t0
    out["read_table_frames"] = len(frames)
    assert len(frames) == -(-n // GRPC_FRAME_ROWS), len(frames)
    got = pa.concat_tables(frames).sort_by("id")
    want = at.sort_by("id")
    for name in at.column_names:
        assert got.column(name).to_pylist() == \
            want.column(name).to_pylist(), name
    res, _ = t.execute("SELECT count(*) AS n, sum(amt) AS s FROM grpc_ev")
    assert res.column("n").to_pylist() == [n]
    assert res.column("s").to_pylist()[0] == \
        decimal.Decimal(int(cents.sum())).scaleb(-2)
    assert isinstance(got.column("d").to_pylist()[0], datetime.date)
    # interactive transactions on a row table
    t.create_table("grpc_acct", [("id", "int64", True),
                                 ("bal", "int64", False)],
                   primary_key=["id"], store="row", shards=2)
    t.execute("INSERT INTO grpc_acct VALUES (1, 100), (2, 50), (3, 0)")
    other = drv.table_client()

    def balances():
        r, _ = other.execute("SELECT id, bal FROM grpc_acct ORDER BY id")
        return r.column("bal").to_pylist()

    t0 = time.perf_counter()
    _, tx = t.execute("UPDATE grpc_acct SET bal = bal - 30 WHERE id = 1",
                      begin=True)
    assert tx
    assert balances() == [100, 50, 0]  # not visible while open
    (_step, committed), tx2 = t.execute(
        "UPDATE grpc_acct SET bal = bal + 30 WHERE id = 2", tx_id=tx,
        commit=True)
    assert committed and tx2 == ""
    assert balances() == [70, 80, 0]
    _, tx = t.execute("UPDATE grpc_acct SET bal = bal + 999 WHERE id = 3",
                      begin=True)
    t.execute("ROLLBACK", tx_id=tx)
    assert balances() == [70, 80, 0]
    try:
        t.execute("UPDATE grpc_acct SET bal = 1 WHERE id = 3", tx_id=tx)
        raise AssertionError("a rolled-back tx id was accepted")
    except ApiError as e:
        assert "unknown tx" in str(e), e
    # DeleteSession with the tx still open rolls it back, locks freed
    _, tx = t.execute("UPDATE grpc_acct SET bal = 0 WHERE id = 1",
                      begin=True)
    assert tx
    t.close()
    assert balances() == [70, 80, 0]
    (_step, committed), _ = other.execute(
        "UPDATE grpc_acct SET bal = 71 WHERE id = 1", begin=True,
        commit=True)
    assert committed and balances() == [71, 80, 0]
    out["transactions_s"] = time.perf_counter() - t0
    other.close()
    return out


def grpc_scheme(drv, tpch_rows) -> dict:
    """Step 4: Scheme, Operation and Scripting. ``ListDirectory`` holds
    every TPC-H table; ``DescribeTable`` of each has its primary key and a
    ``COUNT(*)`` over gRPC of ``tpch_rows``; an asynchronous export of
    customer polled to ready, imported under a new name; a script reads
    the copy's ``COUNT(*)`` and ``SUM(c_acctbal)``, equal to the
    original's."""
    from ydb_tpu_torch.api.arrow_io import ipc_to_table
    from ydb_tpu_torch.api.server import pb
    from ydb_tpu_torch.workload import tpch

    out: dict = {}
    sc = drv.scheme_client()
    entries = dict(sc.list_directory("/"))
    q = drv.query_client()
    for t, n in tpch_rows.items():
        assert entries.get("/" + t) == "table", (t, entries)
        d = sc.describe_table("/" + t)
        assert tuple(d.primary_key) == tuple(tpch.PRIMARY_KEYS[t]), (t, d)
        got = q.execute(f"SELECT count(*) AS n FROM {t}")
        assert got.column("n").to_pylist() == [n], (t, n)
    t0 = time.perf_counter()
    resp = drv._call("/ydb_tpu.Export/ExportBackup",
                     pb.ExportRequest(table="customer", name="grpc_cust",
                                      async_op=True), pb.ExportResponse)
    assert resp.operation_id and not resp.error, resp
    polls = 0
    while True:
        st = drv._call("/ydb_tpu.Operation/GetOperation",
                       pb.GetOperationRequest(id=resp.operation_id),
                       pb.OperationStatus)
        polls += 1
        if st.ready:
            break
        assert time.perf_counter() - t0 < 120, "export did not finish"
        time.sleep(0.05)
    assert not st.error and st.rows == tpch_rows["customer"], st
    out["export_s"] = time.perf_counter() - t0
    out["export_polls"] = polls
    t0 = time.perf_counter()
    rows = drv.export_client().import_table("grpc_cust",
                                            table="customer_grpc", shards=4)
    assert rows == tpch_rows["customer"], rows
    out["import_s"] = time.perf_counter() - t0
    check = "SELECT count(*) AS n, sum(c_acctbal) AS s FROM {}"
    r = drv._call("/ydb_tpu.Scripting/ExecuteScript",
                  pb.ExecuteScriptRequest(script=(
                      check.format("customer") + "; "
                      + check.format("customer_grpc"))),
                  pb.ExecuteScriptResponse)
    assert not r.error and len(r.statements) == 2, r.error
    copy = ipc_to_table(r.last_result_ipc).to_pydict()
    orig = q.execute(check.format("customer")).to_pydict()
    assert copy == orig and copy["n"] == [tpch_rows["customer"]], \
        (copy, orig)
    out["customer"] = {"rows": copy["n"][0], "sum_acctbal": str(copy["s"][0])}
    q.close()
    return out


def grpc_services(drv) -> dict:
    """Step 5: Coordination (a semaphore held by one session refuses a
    second until released), RateLimiter (``GRPC_RL_CALLS`` acquisitions:
    at most burst + rate x elapsed + 1 granted), Cms (a config set reads
    back with its version; a stale one refused), Monitoring (GOOD), Auth
    (a second server with ``auth_tokens`` refuses a bad ticket), and a
    KeyValue RPC answering UNIMPLEMENTED (phase 16 drives the Topic
    service)."""
    import grpc

    from ydb_tpu_torch.api.server import pb

    out: dict = {}
    mk = pb.CoordSemaphoreRequest
    sess = [drv._call("/ydb_tpu.Coordination/CreateSession",
                      pb.CoordSessionRequest(timeout_s=60.0),
                      pb.CoordSessionResponse).session_id for _ in range(2)]
    r = drv._call("/ydb_tpu.Coordination/CreateSemaphore",
                  mk(name="grpc_lock", limit=1), pb.CoordSemaphoreResponse)
    assert not r.error, r.error
    acq = "/ydb_tpu.Coordination/AcquireSemaphore"

    def acquire(i):
        return drv._call(acq, mk(session_id=sess[i], name="grpc_lock",
                                 count=1), pb.CoordSemaphoreResponse)

    assert acquire(0).acquired
    assert not acquire(1).acquired
    desc = drv._call("/ydb_tpu.Coordination/DescribeSemaphore",
                     mk(name="grpc_lock"), pb.CoordSemaphoreResponse)
    assert desc.count == 1 and list(desc.owners) == [sess[0]], desc
    drv._call("/ydb_tpu.Coordination/ReleaseSemaphore",
              mk(session_id=sess[0], name="grpc_lock"),
              pb.CoordSemaphoreResponse)
    assert acquire(1).acquired
    out["semaphore_owner_after_release"] = sess[1]
    # the rate limiter
    rl = drv.rate_limiter_client()
    rl.create_resource("grpc/calls", rate=GRPC_RL_RATE, burst=GRPC_RL_BURST)
    t0 = time.perf_counter()
    granted = sum(rl.acquire("grpc/calls")[0] for _ in range(GRPC_RL_CALLS))
    elapsed = time.perf_counter() - t0
    limit = GRPC_RL_BURST + GRPC_RL_RATE * elapsed + 1
    out["rate_limiter"] = {"calls": GRPC_RL_CALLS, "granted": granted,
                           "elapsed_s": elapsed, "limit": limit}
    assert GRPC_RL_BURST <= granted <= limit, out["rate_limiter"]
    # Cms
    set_ = drv._call("/ydb_tpu.Cms/SetConfig",
                     pb.SetConfigRequest(yaml="n_shards: 4",
                                         expect_version=-1),
                     pb.SetConfigResponse)
    assert not set_.error and set_.version >= 1, set_
    got = drv._call("/ydb_tpu.Cms/GetConfig", pb.GetConfigRequest(),
                    pb.GetConfigResponse)
    assert got.yaml.strip() == "n_shards: 4" and \
        got.version == set_.version, got
    stale = drv._call("/ydb_tpu.Cms/SetConfig",
                      pb.SetConfigRequest(yaml="n_shards: 4",
                                          expect_version=set_.version - 1),
                      pb.SetConfigResponse)
    assert stale.error, stale
    out["cms_version"] = got.version
    # Monitoring
    h = drv._call("/ydb_tpu.Monitoring/HealthCheck", pb.HealthCheckRequest(),
                  pb.HealthCheckResponse)
    assert h.status == "GOOD", h
    # KeyValue: registered, not ported
    try:
        drv._call("/ydb_tpu.KeyValue/Read", pb.KvReadRequest(volume="v"),
                  pb.KvReadResponse)
        raise AssertionError("/ydb_tpu.KeyValue/Read answered")
    except grpc.RpcError as e:
        assert e.code() == grpc.StatusCode.UNIMPLEMENTED, e
        assert "item 12" in e.details(), e.details()
        out["unimplemented"] = [e.details()]
    return out


def grpc_auth(cluster) -> dict:
    """Step 5, Auth: a second server over the same Cluster with
    ``auth_tokens``: a bad ticket is UNAUTHENTICATED, a good one is the
    principal WhoAmI reports."""
    import grpc

    from ydb_tpu_torch.api.client import Driver
    from ydb_tpu_torch.api.server import make_server, pb

    srv, port = make_server(cluster, port=0, auth_tokens={"grpc-token"})
    srv.start()
    try:
        bad = Driver(f"127.0.0.1:{port}", auth_token="wrong")
        try:
            bad.query_client()
            raise AssertionError("a bad ticket was served")
        except grpc.RpcError as e:
            assert e.code() == grpc.StatusCode.UNAUTHENTICATED, e
        bad.close()
        good = Driver(f"127.0.0.1:{port}", auth_token="grpc-token")
        w = good._call("/ydb_tpu.Auth/WhoAmI", pb.WhoAmIRequest(),
                       pb.WhoAmIResponse)
        assert w.authenticated and w.user == "grpc-token", w
        good.close()
    finally:
        srv.stop(0)
        srv.request_proxy.close()
    return {"bad_ticket": "UNAUTHENTICATED", "who_am_i": "grpc-token"}


def grpc_load(port, answers) -> dict:
    """Step 6: ``GRPC_CLIENTS`` threads, one Driver each, send q6 and q33
    in turns for ``GRPC_LOAD_S``; every answer equal to step 2's.
    Statements/s and p50/p99 on the client's clock."""
    import threading

    from ydb_tpu_torch.api.client import Driver

    stmts = sanitize_statements()
    work = (("q6", stmts["q6"]), ("q33", stmts["q33"]))
    stop = threading.Event()
    lat, fail = [], []

    def loop(i):
        try:
            d = Driver(f"127.0.0.1:{port}")
            q = d.query_client()
            k = 0
            while not stop.is_set():
                name, sql = work[(i + k) % 2]
                t0 = time.perf_counter()
                got = q.execute(sql)
                lat.append(time.perf_counter() - t0)
                rows, cols = arrow_wire(got)
                same_wire(rows, answers[name], cols,
                          f"grpc {name} under load", rtol=1e-12)
                k += 1
            q.close()
            d.close()
        except Exception as e:  # noqa: BLE001 - raised below
            fail.append(e)
            stop.set()

    threads = [threading.Thread(target=loop, args=(i,))
               for i in range(GRPC_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    stop.wait(GRPC_LOAD_S)
    stop.set()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if fail:
        raise fail[0]
    ms = [x * 1e3 for x in lat]
    return {"clients": GRPC_CLIENTS, "seconds": wall,
            "statements": len(ms), "statements_per_s": len(ms) / wall,
            "p50_ms": pct(ms, 0.5), "p99_ms": pct(ms, 0.99)}


def grpc_maintenance(cluster, srv) -> dict:
    """Step 7: the node's first maintenance pass, under the server's lock
    as ``cli.py serve``'s loop runs it; on a store just booted,
    ``run_background`` sketches every column table for statistics."""
    with srv.request_proxy.lock:
        stats = cluster.run_background()
    assert stats["cdc_shipped"] == 0, stats
    return {"stats_tables": stats.get("stats_tables")}


def grpc_phase(dev, ck, node, want, tpch_rows) -> dict:
    """Phase 15 (see the module docstring) on ``node`` (``grpc_boot`` of
    phase 10's store; the caller stops it), ``want`` the wire rows of
    ``sanitize_statements()`` there, ``tpch_rows`` the rows of each
    TPC-H table phase 10 loaded. On the CPU (a rehearsal) no kernel is
    counted or checked."""
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    cluster, srv, port, drv, boot_s = node
    steps: dict = {"boot": boot_s}
    out: dict = {}
    for name, fn in (
            ("query", lambda: grpc_query(cluster, drv, ck, want, cuda)),
            ("table", lambda: grpc_table(drv)),
            ("scheme", lambda: grpc_scheme(drv, tpch_rows)),
            ("services", lambda: grpc_services(drv)),
            ("auth", lambda: grpc_auth(cluster)),
            ("load", lambda: grpc_load(port, want)),
            ("maintenance", lambda: grpc_maintenance(cluster, srv))):
        t0 = time.perf_counter()
        out[name] = fn()
        steps[name] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase + boot_s
    out["steps_s"] = steps
    emit({"grpc": {
        "seconds": out["seconds"], "steps_s": steps,
        "launches": out["query"].get("launches"),
        "statement_s": out["query"]["statement_s"],
        "table": out["table"], "scheme": out["scheme"],
        "services": out["services"], "auth": out["auth"],
        "load": out["load"], "maintenance": out["maintenance"]}})
    log(f"grpc phase: {out['seconds']:.1f} s; Q1, Q6, q3, q33, q36 over "
        f"gRPC equal to pgwire's, {GRPC_UPSERT_ROWS} rows upserted and read "
        f"back, customer exported and imported equal, load "
        f"{out['load']['statements_per_s']:.1f} statements/s (p50 "
        f"{out['load']['p50_ms']:.1f} ms, p99 {out['load']['p99_ms']:.1f} "
        f"ms)")
    assert out["seconds"] < GRPC_BUDGET_S, out["seconds"]
    out["launches"] = out["query"].get("launches")
    out["kernel_check"] = out["query"].get("kernel_check", {})
    return out


# ---------------- phase 16: streaming ----------------

#: phase 16's own time limit
STREAM_BUDGET_S = 45.0
#: the changefeed table: rows loaded, its DataShards (and topic
#: partitions), the groups of its ``grp`` column, and the rows per
#: replicator read
STREAM_CDC_ROWS = 20_000
STREAM_CDC_SHARDS = 4
STREAM_CDC_GROUPS = 16
STREAM_REPL_BATCH = 4_096
#: ClickBench-shaped events written into the source topic, its
#: partitions, messages per write, and the rows a partition gives a poll
#: (4 x 12,500 = 50,000-row micro-batches, each over more than 512 URLs)
STREAM_EVENTS = 200_000
STREAM_PARTITIONS = 4
STREAM_WRITE_BATCH = 1_000
STREAM_BATCH_LIMIT = 12_500
STREAM_SEED = 16
#: the tumbling-window query: a week of event time a window, an hour of
#: lateness; events stamped before the first window's end, written after
#: the rest, arrive late
STREAM_WINDOW_US = 7 * 86_400 * 1_000_000
STREAM_LATENESS_US = 3_600 * 1_000_000
STREAM_LATE_EVENTS = 8
#: the poll of the fused run that crashes between its sink write and its
#: checkpoint
STREAM_CRASH_POLL = 3
#: Kafka: keyed messages produced, messages per Produce v2 call, and the
#: topic's partitions
STREAM_KAFKA_MSGS = 20_000
STREAM_KAFKA_BATCH = 500
STREAM_KAFKA_PARTITIONS = 4
#: SQS: messages sent, and the lease of the receive whose message is not
#: deleted (seconds)
STREAM_SQS_MSGS = 50
STREAM_SQS_LEASE_S = 0.3
#: the gRPC topic round trip's messages
STREAM_GRPC_MSGS = 100

STREAM_SQL = ("SELECT URL, count(*) AS n, sum(ResolutionWidth) AS s "
              "FROM stream GROUP BY URL")


def stream_schema():
    from ydb_tpu_torch import dtypes

    return dtypes.schema(("URL", dtypes.STRING, False),
                         ("ResolutionWidth", dtypes.INT32, False),
                         ("EventTime", dtypes.TIMESTAMP, False))


def stream_groups(events, window_us=None) -> dict:
    """The group-by of ``events`` (URL, ResolutionWidth, EventTime
    arrays) on the host: {URL: (count, sum)}, or {(window start, URL):
    (count, sum)}."""
    url, width, t = events
    keys = (url.tolist() if window_us is None else
            list(zip((t // window_us * window_us).tolist(), url.tolist())))
    out: dict = {}
    for k, w in zip(keys, width.tolist()):
        n, s = out.get(k, (0, 0))
        out[k] = (n + 1, s + w)
    return out


def stream_cdc(cluster) -> dict:
    """Step 2: a ``changefeed = on`` row table of ``STREAM_CDC_ROWS``
    rows in ``STREAM_CDC_SHARDS`` shards; UPSERT, UPDATE and DELETE;
    ``run_background`` ships every change; a ``Replicator`` tails the
    changefeed into a replica whose rows equal the source's on the card;
    a ship whose ack is lost, re-shipped, lands once and the replica
    stays equal."""
    from ydb_tpu_torch.replication import Replicator

    s = cluster.session()
    cols = "(id BIGINT NOT NULL, grp BIGINT, v BIGINT, PRIMARY KEY (id))"
    s.execute(f"CREATE TABLE stream_src {cols} WITH (store = row, "
              f"shards = {STREAM_CDC_SHARDS}, changefeed = on)")
    s.execute(f"CREATE TABLE stream_dst {cols} WITH (store = row, "
              f"shards = {STREAM_CDC_SHARDS})")
    src = cluster.tables["stream_src"]
    topic = cluster.topics["stream_src_changefeed"]
    assert len(topic.partitions) == STREAM_CDC_SHARDS
    ids = np.arange(STREAM_CDC_ROWS, dtype=np.int64)
    want = {int(i): (int(i) % STREAM_CDC_GROUPS, int(i)) for i in ids}
    t0 = time.perf_counter()
    assert src.insert({"id": ids, "grp": ids % STREAM_CDC_GROUPS,
                       "v": ids.copy()}).committed
    cluster._invalidate_plans()
    changes = STREAM_CDC_ROWS
    # UPSERT 1,000 rows: half over existing ids, half new
    up = range(STREAM_CDC_ROWS - 500, STREAM_CDC_ROWS + 500)
    assert s.execute("UPSERT INTO stream_src VALUES " + ", ".join(
        f"({i}, {i % STREAM_CDC_GROUPS}, {-i})" for i in up)).committed
    for i in up:
        want[i] = (i % STREAM_CDC_GROUPS, -i)
    changes += len(up)
    assert s.execute("UPDATE stream_src SET v = v + 7 WHERE grp = 3"
                     ).committed
    for k, (g, v) in list(want.items()):
        if g == 3:
            want[k] = (g, v + 7)
            changes += 1
    assert s.execute("DELETE FROM stream_src WHERE grp = 5").committed
    for k in [k for k, (g, _v) in want.items() if g == 5]:
        del want[k]
        changes += 1
    dml_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shipped, passes = 0, 0
    while True:
        n = cluster.run_background()["cdc_shipped"]
        passes += 1
        if not n:
            break
        shipped += n
    ship_s = time.perf_counter() - t0
    assert shipped == changes, (shipped, changes)
    heads = [p.head_offset for p in topic.partitions]
    assert sum(heads) == changes, heads
    t0 = time.perf_counter()
    rep = Replicator(topic, cluster.tables["stream_dst"], consumer="replica",
                     batch=STREAM_REPL_BATCH)
    applied = rep.poll()
    apply_s = time.perf_counter() - t0
    assert applied == changes, (applied, changes)

    def rows(table):
        r = s.execute(f"SELECT id, grp, v FROM {table} ORDER BY id")
        return (np.asarray(r.cols["id"][0]), np.asarray(r.cols["grp"][0]),
                np.asarray(r.cols["v"][0]))

    got_src, got_dst = rows("stream_src"), rows("stream_dst")
    keys = sorted(want)
    for a, b in zip(got_src, (keys, [want[k][0] for k in keys],
                              [want[k][1] for k in keys])):
        assert np.array_equal(a, np.asarray(b, dtype=np.int64))
    assert all(np.array_equal(a, b) for a, b in zip(got_src, got_dst))
    # the exactly-once case: ship a new change, then re-ship it as if the
    # ack were lost; the producer seqno drops the copy
    assert s.execute(f"INSERT INTO stream_src VALUES "
                     f"({STREAM_CDC_ROWS + 1000}, 1, 1)").committed
    shard = next(sh for sh in src.shards if sh.pending_changes())
    lost = shard.pending_changes()
    assert src.drain_changes_to(topic) == 1
    for ch in lost:
        p = topic.partition_for(json.dumps(ch["key"]))
        assert topic.partitions[p].write(
            [{"data": "redelivered"}], producer=f"cdc/{shard.shard_id}",
            first_seqno=ch["seq"]) == [-1]
    assert sum(p.head_offset for p in topic.partitions) == changes + 1
    assert rep.poll() == 1
    got_src, got_dst = rows("stream_src"), rows("stream_dst")
    assert all(np.array_equal(a, b) for a, b in zip(got_src, got_dst))
    out = {"rows": STREAM_CDC_ROWS, "shards": STREAM_CDC_SHARDS,
           "changes": changes, "cdc_shipped": shipped,
           "background_passes": passes, "dml_s": dml_s, "ship_s": ship_s,
           "changes_shipped_per_s": shipped / ship_s,
           "replicated": applied, "apply_s": apply_s,
           "replica_rows": len(got_dst[0]), "replica_equal": True,
           "redelivery_deduplicated": True,
           "heads": [p.head_offset for p in topic.partitions],
           "replica_committed": [p.committed("replica")
                                 for p in topic.partitions]}
    log(f"stream cdc: {changes} changes shipped in {passes} background "
        f"passes ({ship_s:.2f} s), replicated in {apply_s:.2f} s; replica "
        "equal to the source on the card; a lost ack's re-ship dropped")
    return out


def stream_events(cb) -> tuple:
    """``STREAM_EVENTS`` JSON messages of the ClickBench columns the
    streaming query reads (URL, ResolutionWidth, EventTime): ``cb``'s
    rows but the last ``STREAM_LATE_EVENTS`` in event-time order, with
    ``STREAM_LATE_EVENTS`` copies of its first rows (stamped in the first
    window) written after 60% of them, by when that window is closed.
    Returns the messages, the on-time columns and all columns."""
    h = cb.hits
    order = np.argsort(h["EventTime"], kind="stable")
    order = order[:len(order) - STREAM_LATE_EVENTS]
    url = np.asarray([u.decode("utf-8", "surrogateescape") for u in
                      cb.dicts["URL"].decode(h["URL"][order])])
    width = h["ResolutionWidth"][order].astype(np.int64)
    t = h["EventTime"][order].astype(np.int64)

    def encode(cols):
        # json.dumps of {"URL": u, "ResolutionWidth": w, "EventTime": x}
        return ['{"URL": %s, "ResolutionWidth": %d, "EventTime": %d}'
                % (json.dumps(u), w, x)
                for u, w, x in zip(*(c.tolist() for c in cols))]

    on_time = (url, width, t)
    late = tuple(c[:STREAM_LATE_EVENTS] for c in on_time)
    msgs = encode(on_time)
    cut = len(msgs) * 6 // 10
    msgs[cut:cut] = encode(late)
    every = tuple(np.concatenate([a, b]) for a, b in zip(on_time, late))
    return msgs, on_time, every


def stream_write(topic, msgs) -> float:
    """Message i into partition i % n, ``STREAM_WRITE_BATCH`` a write,
    with producer seqnos; returns the seconds."""
    n = len(topic.partitions)
    t0 = time.perf_counter()
    for p in range(n):
        mine = msgs[p::n]
        for lo in range(0, len(mine), STREAM_WRITE_BATCH):
            offs = topic.partitions[p].write(
                [{"data": m} for m in mine[lo:lo + STREAM_WRITE_BATCH]],
                producer=f"gen/{p}", first_seqno=lo + 1)
            assert offs[0] == lo and -1 not in offs, (p, lo)
    return time.perf_counter() - t0


def count_groups(q, groups):
    """``q`` with its micro-batches' group counts landing in ``groups``."""
    run = q._run_batch

    def counted(rows):
        out = run(rows)
        groups.append(len(out))
        return out

    q._run_batch = counted
    return q


def stream_query(svc, name, source, sink, groups, **kw):
    return count_groups(svc.create_query(
        name, STREAM_SQL, stream_schema(), source, sink,
        batch_limit=STREAM_BATCH_LIMIT, **kw), groups)


def drain(q) -> tuple[int, float]:
    t0, polls = time.perf_counter(), 0
    while q.poll():
        polls += 1
    return polls, time.perf_counter() - t0


def by_url(results) -> dict:
    return {r["URL"]: (r["n"], r["s"]) for r in results}


class _Crash(Exception):
    """The simulated crash between a poll's sink write and checkpoint."""


def stream_fq(cluster, dev, ck, cuda) -> dict:
    """Step 1: the streaming query on the card. ``STREAM_EVENTS``
    ClickBench-shaped events into a ``STREAM_PARTITIONS``-partition topic;
    the GROUP BY URL query on the fused lowering (its poll
    ``STREAM_CRASH_POLL`` crashes between the sink write and the
    checkpoint; a query rebuilt from the checkpoint replays it) and on
    the per-aggregate lowering with fusion off, launch counters zeroed
    before and read after, every micro-batch over more than
    ``ONEHOT_GROUP_LIMIT`` groups, ``results()`` equal to numpy; one
    micro-batch's kernel calls held against the plain versions (not
    counted); the tumbling-window query, each window emitted once."""
    from ydb_tpu_torch.fq import FederatedQueryService, StreamingQuery
    from ydb_tpu_torch.ssa import kernels
    from ydb_tpu_torch.topic.topic import Topic
    from ydb_tpu_torch.workload import clickbench

    out: dict = {}
    t0 = time.perf_counter()
    cb = clickbench.ClickBenchData(rows=STREAM_EVENTS, seed=STREAM_SEED)
    msgs, on_time, every = stream_events(cb)
    del cb
    out["datagen_s"] = time.perf_counter() - t0
    store = cluster.store
    source = Topic("clicks", store, n_partitions=STREAM_PARTITIONS)
    cluster.topics["clicks"] = source
    out["write_s"] = stream_write(source, msgs)
    out["events_written_per_s"] = len(msgs) / out["write_s"]
    want = stream_groups(every)
    svc = FederatedQueryService(store, device=dev)
    sink = Topic("clicks_out", store, n_partitions=1)
    groups: dict = {"fused": [], "peragg": []}
    if cuda:
        ck.reset_launches()
    # the fused lowering (default routing: one fused dispatch a batch)
    q = stream_query(svc, "clicks_fused", source, sink, groups["fused"])
    t0 = time.perf_counter()
    for _ in range(STREAM_CRASH_POLL - 1):
        assert q.poll()
    head = sink.partitions[0].head_offset
    real_run = q.executor.run

    def crash(_fn):
        raise _Crash()

    q.executor.run = crash
    try:
        q.poll()
        raise AssertionError("the crash poll checkpointed")
    except _Crash:
        pass
    q.executor.run = real_run
    emitted = sink.partitions[0].head_offset
    assert emitted > head
    stats = dict(q.stats)
    svc.delete_query("clicks_fused")
    q = count_groups(StreamingQuery(
        "clicks_fused", STREAM_SQL, stream_schema(), source, sink, store,
        batch_limit=STREAM_BATCH_LIMIT, device=dev), groups["fused"])
    assert q.poll()  # the replay: its emission is dropped as a duplicate
    assert sink.partitions[0].head_offset == emitted
    drain(q)
    fused_s = time.perf_counter() - t0
    for k in stats:
        stats[k] += q.stats[k]
    assert by_url(q.results()) == want
    recs = sink.partitions[0].read(0, limit=1 << 20)
    seqnos = [m["seqno"] for m in recs]
    assert seqnos == list(range(1, len(recs) + 1)), seqnos[:5]
    assert q._state()[2] == len(recs)
    last = {}
    for m in recs:
        r = json.loads(m["data"])
        last[r["URL"]] = (r["n"], r["s"])
    assert last == want
    out["fused"] = {"seconds": fused_s, "stats": stats,
                    "events_per_s": stats["rows"] / fused_s,
                    "sink_records": len(recs),
                    "crash": {"poll": STREAM_CRASH_POLL,
                              "emissions_dropped_on_replay": emitted - head}}
    # the per-aggregate lowering, fusion off
    kernels.FUSED_FORCE = False
    try:
        with fusion_force(False):
            p = stream_query(svc, "clicks_peragg", source, None,
                             groups["peragg"])
            polls_p, peragg_s = drain(p)
    finally:
        kernels.FUSED_FORCE = None
    if cuda:
        out["launches"] = dict(ck.LAUNCHES)
        log(f"stream launches (GROUP BY URL over {STREAM_EVENTS} events, "
            f"fused, then per-aggregate): {out['launches']}")
        assert all(v > 0 for v in out["launches"].values()), out["launches"]
    assert by_url(p.results()) == want
    out["peragg"] = {"seconds": peragg_s, "polls": polls_p,
                     "stats": dict(p.stats),
                     "events_per_s": p.stats["rows"] / peragg_s}
    for lowering, gs in groups.items():
        assert gs and min(gs) > kernels.ONEHOT_GROUP_LIMIT, (lowering, gs)
    out["groups_per_batch"] = groups
    # one micro-batch's kernel calls against the plain versions
    if cuda:
        batch = [json.loads(m) for m in msgs[:STREAM_PARTITIONS
                                              * STREAM_BATCH_LIMIT]]
        out["kernel_check"] = {}
        with fusion_force(False):
            for lowering, force, kernel in (
                    ("fused", None, "grouped_sum_multi"),
                    ("peragg", False, "grouped_sum")):
                kernels.FUSED_FORCE = force
                try:
                    row = checked_kernel_calls(
                        ck, lambda: StreamingQuery._run_batch(p, batch))
                finally:
                    kernels.FUSED_FORCE = None
                assert row[kernel]["calls"] > 0, (lowering, row)
                out["kernel_check"][lowering] = row
        emit({"stream_kernel_check": out["kernel_check"]})
    # the tumbling-window query
    wsink = Topic("clicks_windows", store, n_partitions=1)
    wgroups: list = []
    w = stream_query(svc, "clicks_window", source, wsink, wgroups,
                     window=("EventTime", STREAM_WINDOW_US,
                             STREAM_LATENESS_US))
    wpolls, window_s = drain(w)
    wm = w.watermark_info()
    assert wm["late_dropped"] == STREAM_LATE_EVENTS, wm
    emitted_w = [json.loads(m["data"]) for m in
                 wsink.partitions[0].read(0, limit=1 << 20)]
    rows = emitted_w + w.results()
    got = {(r["window_start"], r["URL"]): (r["n"], r["s"]) for r in rows}
    assert len(got) == len(rows)  # each (window, URL) once
    assert got == stream_groups(on_time, STREAM_WINDOW_US)
    assert all(r["window_end"] <= wm["finalized_before"]
               for r in emitted_w)
    out["window"] = {"seconds": window_s, "polls": wpolls,
                     "stats": dict(w.stats), "emitted": len(emitted_w),
                     "open": len(rows) - len(emitted_w),
                     "windows": len({r["window_start"] for r in rows}),
                     "late_dropped": wm["late_dropped"],
                     "events_per_s": w.stats["rows"] / window_s}
    log(f"stream fq: {len(msgs)} events written at "
        f"{out['events_written_per_s']:.0f}/s; GROUP BY URL fused "
        f"{out['fused']['events_per_s']:.0f} events/s over "
        f"{stats['polls']} polls ({stats['captures']} captures, "
        f"{stats['replays']} replays), per-aggregate "
        f"{out['peragg']['events_per_s']:.0f} events/s; each equal to "
        f"numpy; windows {out['window']['windows']}, late "
        f"{wm['late_dropped']}; the crashed poll's replay emitted nothing "
        "twice")
    return out


def _kafka_str(s):
    b = s.encode()
    return struct.pack("!h", len(b)) + b


def _kafka_bytes(b):
    return struct.pack("!i", -1) if b is None else \
        struct.pack("!i", len(b)) + b


def _kafka_message_set(entries, corrupt=False):
    out = []
    for key, value, ts in entries:
        body = (struct.pack("!bbq", 1, 0, ts) + _kafka_bytes(key)
                + _kafka_bytes(value))
        crc = zlib.crc32(body) & 0xFFFFFFFF
        if corrupt:
            crc ^= 0x5A5A
        msg = struct.pack("!I", crc) + body
        out.append(struct.pack("!qi", -1, len(msg)) + msg)
    return b"".join(out)


class KafkaWire:
    """A minimal Kafka client (pre-flexible framing): one socket, one
    request in flight."""

    def __init__(self, port):
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=30)
        self.corr = 0
        self.calls = 0

    def call(self, api_key, version, body) -> bytes:
        self.corr += 1
        req = (struct.pack("!hhi", api_key, version, self.corr)
               + _kafka_str("chip_smoke") + body)
        self.sock.sendall(struct.pack("!i", len(req)) + req)
        (size,) = struct.unpack("!i", self._recv(4))
        payload = self._recv(size)
        assert struct.unpack("!i", payload[:4])[0] == self.corr
        self.calls += 1
        return payload[4:]

    def _recv(self, n) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            assert chunk, "kafka server closed the connection"
            buf += chunk
        return buf

    def close(self):
        self.sock.close()


class _KReader:
    def __init__(self, buf):
        self.buf, self.off = buf, 0

    def take(self, fmt):
        v = struct.unpack_from(fmt, self.buf, self.off)
        self.off += struct.calcsize(fmt)
        return v[0] if len(v) == 1 else v

    def string(self):
        n = self.take("!h")
        s = self.buf[self.off:self.off + n].decode()
        self.off += n
        return s

    def bytes_(self):
        n = self.take("!i")
        if n < 0:
            return None
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b


def _kafka_parse_set(buf) -> list:
    out, off = [], 0
    while off + 12 <= len(buf):
        o, size = struct.unpack_from("!qi", buf, off)
        off += 12
        body = buf[off:off + size]
        off += size
        if len(body) < size:
            break
        assert zlib.crc32(body[4:]) & 0xFFFFFFFF == \
            struct.unpack_from("!I", body)[0], "fetched message CRC"
        r = _KReader(body[4:])
        r.take("!b")
        r.take("!b")
        ts = r.take("!q")
        out.append((o, ts, r.bytes_(), r.bytes_()))
    return out


def stream_kafka(cluster, port) -> dict:
    """Step 3: a port ``KafkaServer``: ``STREAM_KAFKA_MSGS`` keyed
    messages produced in Produce v2 batches and fetched back equal; a
    consumer group's commit fetched back; a bad CRC refused."""
    from ydb_tpu_torch.topic.topic import Topic

    name = "kafka_events"
    topic = Topic(name, cluster.store, n_partitions=STREAM_KAFKA_PARTITIONS)
    cluster.topics[name] = topic
    c = KafkaWire(port)
    try:
        meta = _KReader(c.call(3, 1, struct.pack("!i", 1)
                               + _kafka_str(name)))
        assert meta.take("!i") == 1  # one broker
        sent: dict = {p: [] for p in range(STREAM_KAFKA_PARTITIONS)}
        t0 = time.perf_counter()
        for lo in range(0, STREAM_KAFKA_MSGS, STREAM_KAFKA_BATCH):
            batch = [(f"user-{i % 997}".encode(), f"event {i}".encode(),
                      (1_600_000_000 + i) * 1000)
                     for i in range(lo, lo + STREAM_KAFKA_BATCH)]
            part = (lo // STREAM_KAFKA_BATCH) % STREAM_KAFKA_PARTITIONS
            body = (struct.pack("!hi", 1, 10_000) + struct.pack("!i", 1)
                    + _kafka_str(name) + struct.pack("!i", 1)
                    + struct.pack("!i", part)
                    + _kafka_bytes(_kafka_message_set(batch)))
            r = _KReader(c.call(0, 2, body))
            assert r.take("!i") == 1 and r.string() == name
            assert r.take("!i") == 1
            pid, err, base = r.take("!i"), r.take("!h"), r.take("!q")
            assert (pid, err, base) == (part, 0, len(sent[part])), \
                (pid, err, base)
            sent[part] += batch
        produce_s = time.perf_counter() - t0
        produce_calls = STREAM_KAFKA_MSGS // STREAM_KAFKA_BATCH
        t0 = time.perf_counter()
        fetch_calls = 0
        for part, want in sent.items():
            got, off = [], 0
            while off < len(want):
                body = (struct.pack("!iii", -1, 100, 1)
                        + struct.pack("!i", 1) + _kafka_str(name)
                        + struct.pack("!i", 1)
                        + struct.pack("!iqi", part, off, 1 << 18))
                r = _KReader(c.call(1, 2, body))
                fetch_calls += 1
                r.take("!i")
                assert r.take("!i") == 1 and r.string() == name
                assert r.take("!i") == 1
                pid, err, hw = r.take("!i"), r.take("!h"), r.take("!q")
                assert (pid, err, hw) == (part, 0, len(want))
                msgs = _kafka_parse_set(r.bytes_())
                assert msgs, (part, off)
                got += msgs
                off = msgs[-1][0] + 1
            assert [(o, k, v, ts) for o, ts, k, v in got] == [
                (i, k, v, ts) for i, (k, v, ts) in enumerate(want)], part
        fetch_s = time.perf_counter() - t0
        # a consumer group: commit, then fetch the commit back
        commit = (_kafka_str("chip-group") + struct.pack("!i", -1)
                  + _kafka_str("m") + struct.pack("!q", -1)
                  + struct.pack("!i", 1) + _kafka_str(name)
                  + struct.pack("!i", 1) + struct.pack("!iq", 2, 1234)
                  + struct.pack("!h", -1))
        r = _KReader(c.call(8, 2, commit))
        assert r.take("!i") == 1 and r.string() == name
        assert r.take("!i") == 1 and (r.take("!i"), r.take("!h")) == (2, 0)
        r = _KReader(c.call(9, 1, _kafka_str("chip-group")
                            + struct.pack("!i", 1) + _kafka_str(name)
                            + struct.pack("!ii", 1, 2)))
        assert r.take("!i") == 1 and r.string() == name
        assert r.take("!i") == 1
        assert (r.take("!i"), r.take("!q")) == (2, 1234)
        assert topic.partitions[2].committed("chip-group") == 1234
        # a bad CRC is refused, nothing appended
        body = (struct.pack("!hi", 1, 10_000) + struct.pack("!i", 1)
                + _kafka_str(name) + struct.pack("!i", 1)
                + struct.pack("!i", 0) + _kafka_bytes(_kafka_message_set(
                    [(None, b"bad", 1)], corrupt=True)))
        r = _KReader(c.call(0, 2, body))
        r.take("!i")
        r.string()
        r.take("!i")
        assert (r.take("!i"), r.take("!h")) == (0, 2)  # CORRUPT_MESSAGE
        assert topic.partitions[0].head_offset == len(sent[0])
        calls = c.calls
    finally:
        c.close()
    out = {"messages": STREAM_KAFKA_MSGS, "produce_calls": produce_calls,
           "produce_s": produce_s,
           "produce_calls_per_s": produce_calls / produce_s,
           "produced_per_s": STREAM_KAFKA_MSGS / produce_s,
           "fetch_calls": fetch_calls, "fetch_s": fetch_s,
           "fetch_calls_per_s": fetch_calls / fetch_s,
           "fetched_per_s": STREAM_KAFKA_MSGS / fetch_s,
           "round_trips": calls}
    log(f"stream kafka: {STREAM_KAFKA_MSGS} messages produced in "
        f"{produce_calls} Produce v2 calls ({out['produced_per_s']:.0f}/s) "
        f"and fetched back equal in {fetch_calls} ({out['fetched_per_s']:.0f}"
        "/s); group offset committed and read back; bad CRC refused")
    return out


def stream_sqs(port) -> dict:
    """Step 4: a port ``SqsHttpServer``: CreateQueue, ``STREAM_SQS_MSGS``
    SendMessage, ReceiveMessage and DeleteMessage; a message left
    undeleted past its ``STREAM_SQS_LEASE_S`` lease comes back; the
    queue ends with ApproximateNumberOfMessages 0."""
    import urllib.request

    calls = [0]

    def call(action, params):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/", data=json.dumps(params).encode(),
            headers={"X-Amz-Target": f"AmazonSQS.{action}",
                     "Content-Type": "application/x-amz-json-1.0"},
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            calls[0] += 1
            return json.loads(r.read())

    def delete(m):
        call("DeleteMessage", {"QueueUrl": url,
                               "ReceiptHandle": m["ReceiptHandle"]})

    t0 = time.perf_counter()
    url = call("CreateQueue", {"QueueName": "chip_jobs"})["QueueUrl"]
    for i in range(STREAM_SQS_MSGS):
        call("SendMessage", {"QueueUrl": url, "MessageBody": f"job {i}"})
    # one message leased for STREAM_SQS_LEASE_S and never deleted
    (kept,) = call("ReceiveMessage", {
        "QueueUrl": url,
        "VisibilityTimeout": STREAM_SQS_LEASE_S})["Messages"]
    got, again = [kept["Body"]], None
    while True:
        msgs = call("ReceiveMessage", {
            "QueueUrl": url, "MaxNumberOfMessages": 10,
            "VisibilityTimeout": 60})["Messages"]
        if not msgs:
            if again is not None:
                break
            time.sleep(STREAM_SQS_LEASE_S)  # until the lease lapses
            continue
        for m in msgs:
            if m["Body"] == kept["Body"]:
                again = m  # redelivered: its lease lapsed
            else:
                got.append(m["Body"])
            delete(m)
    assert sorted(got) == sorted(f"job {i}" for i in range(STREAM_SQS_MSGS))
    assert again["ReceiptHandle"] != kept["ReceiptHandle"]
    attrs = call("GetQueueAttributes", {"QueueUrl": url})["Attributes"]
    assert attrs["ApproximateNumberOfMessages"] == "0", attrs
    seconds = time.perf_counter() - t0
    out = {"messages": STREAM_SQS_MSGS, "round_trips": calls[0],
           "seconds": seconds, "round_trips_per_s": calls[0] / seconds,
           "redelivered": kept["Body"]}
    log(f"stream sqs: {calls[0]} round trips ({out['round_trips_per_s']:.0f}"
        "/s); an undeleted message came back after its lease; queue empty")
    return out


def stream_grpc(cluster, port) -> dict:
    """Step 5: the gRPC Topic service: Write/Read/Commit round trip and a
    StreamRead of the changefeed topic equal to a direct read; the CLI's
    ``topic write`` and ``topic read`` in process."""
    import contextlib
    import io

    from ydb_tpu_torch import cli
    from ydb_tpu_torch.api.client import Driver
    from ydb_tpu_torch.topic.topic import Topic

    cluster.topics["grpc_events"] = Topic("grpc_events", cluster.store,
                                          n_partitions=2)
    drv = Driver(f"127.0.0.1:{port}")
    try:
        tc = drv.topic_client()
        t0 = time.perf_counter()
        placed = [tc.write("grpc_events", f"m{i}", key=f"k{i % 7}")
                  for i in range(STREAM_GRPC_MSGS)]
        got = tc.read("grpc_events", "chip", limit=STREAM_GRPC_MSGS)
        assert sorted((p, o) for p, o, _d in got) == sorted(placed)
        assert sorted(d for _p, _o, d in got) == sorted(
            f"m{i}".encode() for i in range(STREAM_GRPC_MSGS))
        tops: dict = {}
        for p, o, _d in got:
            tops[p] = max(tops.get(p, -1), o)
        for p, o in tops.items():
            tc.commit("grpc_events", "chip", p, o)
        assert tc.read("grpc_events", "chip") == []
        rt_s = time.perf_counter() - t0
        feed = cluster.topics["stream_src_changefeed"]
        direct = sorted((pi, m["offset"], m["data"].encode())
                        for pi, part in enumerate(feed.partitions)
                        for m in part.read(0, limit=1 << 20))
        t0 = time.perf_counter()
        streamed = sorted(tc.stream_read("stream_src_changefeed", "grpc",
                                         max_batch=4096,
                                         idle_timeout_ms=300))
        stream_s = time.perf_counter() - t0
        assert streamed == direct, (len(streamed), len(direct))
        ep = ["-e", f"127.0.0.1:{port}"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["topic", "write", *ep, "grpc_events", "from-cli",
                      "--key", "cli"])
            cli.main(["topic", "read", *ep, "grpc_events", "--consumer",
                      "chip", "--commit"])
        printed = buf.getvalue().splitlines()
        assert printed[0].startswith("partition "), printed
        assert len(printed) == 2 and printed[1].endswith("] from-cli"), \
            printed
    finally:
        drv.close()
    out = {"round_trip_messages": STREAM_GRPC_MSGS, "round_trip_s": rt_s,
           "writes_per_s": STREAM_GRPC_MSGS / rt_s,
           "stream_read_messages": len(streamed), "stream_read_s": stream_s,
           "cli": printed}
    log(f"stream grpc: {STREAM_GRPC_MSGS} Topic writes, read and commit in "
        f"{rt_s:.2f} s; StreamRead of {len(streamed)} changefeed messages "
        f"in {stream_s:.2f} s; CLI topic write/read: {printed}")
    return out


def stream_phase(dev, ck, node, root) -> dict:
    """Phase 16 (see the module docstring) on ``node``, phase 15's
    (``grpc_boot`` of phase 10's store ``root``); it stops the node. On
    the CPU (a rehearsal) no kernel is counted or checked."""
    from ydb_tpu_torch.api.kafka import KafkaServer
    from ydb_tpu_torch.api.sqs import SqsHttpServer
    from ydb_tpu_torch.config import AppConfig
    from ydb_tpu_torch.engine.blobs import DirBlobStore
    from ydb_tpu_torch.kqp.session import Cluster

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    steps: dict = {}
    out: dict = {}
    t0 = time.perf_counter()
    cluster, srv, port, _drv, _boot_s = node
    lock = srv.request_proxy.lock
    kafka = sqs = None
    try:
        kafka = KafkaServer(cluster, port=0, lock=lock).start()
        sqs = SqsHttpServer(cluster.store, port=0, lock=lock).start()
        steps["fronts"] = time.perf_counter() - t0
        for name, fn in (
                ("fq", lambda: stream_fq(cluster, dev, ck, cuda)),
                ("cdc", lambda: stream_cdc(cluster)),
                ("kafka", lambda: stream_kafka(cluster, kafka.port)),
                ("sqs", lambda: stream_sqs(sqs.port)),
                ("grpc", lambda: stream_grpc(cluster, port))):
            t0 = time.perf_counter()
            out[name] = fn()
            steps[name] = time.perf_counter() - t0
    finally:
        t_stop = time.perf_counter()
        for front in (kafka, sqs):
            if front is not None:
                front.stop()
        stop_node(node)
    steps["stop"] = time.perf_counter() - t_stop
    # a Cluster booted again from the directory reads the changefeed's
    # offsets and the replica's commits back
    t0 = time.perf_counter()
    again = Cluster(store=DirBlobStore(root), device=dev, config=AppConfig())
    try:
        feed = again.topics["stream_src_changefeed"]
        heads = [p.head_offset for p in feed.partitions]
        assert heads == out["cdc"]["heads"], heads
        assert [p.committed("replica") for p in feed.partitions] == heads
        assert not any(sh.pending_changes()
                       for sh in again.tables["stream_src"].shards)
    finally:
        again.stop()
    steps["reboot"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    out["steps_s"] = steps
    emit({"streaming": {
        "seconds": out["seconds"], "steps_s": steps,
        "launches": out["fq"].get("launches"),
        "cdc": out["cdc"], "fq": {k: v for k, v in out["fq"].items()
                                  if k not in ("kernel_check",
                                               "launches")},
        "kafka": out["kafka"], "sqs": out["sqs"], "grpc": out["grpc"]}})
    log(f"streaming phase: {out['seconds']:.1f} s; steps "
        + json.dumps({k: round(v, 2) for k, v in steps.items()}))
    assert out["seconds"] < STREAM_BUDGET_S, out["seconds"]
    out["launches"] = out["fq"].get("launches")
    out["kernel_check"] = out["fq"].get("kernel_check", {})
    return out


# ---------------- phase 13: the row store ----------------

#: phase 13's own time limit (data generation included)
ROW_STORE_BUDGET_S = 240.0
#: TPC-H scale of phase 13 (750,000 orders rows in the row table; at
#: SF-1 the phase took 232 s of its 240 s on a slow host, 72 s of it the
#: reboot)
ROW_SF = 0.5
ROW_SEED = 42
#: DataShards of the orders row table
ROW_SHARDS = 8
#: rows per INSERT batch of the row-table load
ROW_LOAD_BATCH = 100_000
#: the transfer workload's row table: accounts, their shards, balances
ACCOUNTS = 100_000
ACCOUNT_SHARDS = 4
ACCOUNT_START = 1_000
#: branch ids (the indexed column) and the branch the index lookup reads
ACCOUNT_BRANCHES = 1_000
LOOKUP_BRANCH = 123
#: interactive transfers: sessions on threads, rounds, transfers a round
#: per session (TX_SESSIONS x TX_ROUNDS x TX_PER_ROUND commits in all)
TX_SESSIONS = 4
TX_ROUNDS = 2
TX_PER_ROUND = 5
TX_SEED = 13

_ROW_RANGE = ("WHERE o_orderdate >= DATE '1995-01-01' "
              "AND o_orderdate < DATE '1998-01-01'")
#: the GROUP BYs over the row table: o_orderdate (about 1,096 groups,
#: which the compiler puts in its sorted tier: no dense bound for a date
#: key without statistics) and o_comment (a dictionary key of about
#: 1,960 ids: the dense tier of the CUDA kernels)
ROW_GROUP_BYS = {
    "gb_date": ("o_orderdate",
                "SELECT o_orderdate, COUNT(*) AS n, SUM(o_totalprice) AS s "
                f"FROM orders {_ROW_RANGE} GROUP BY o_orderdate"),
    "gb_comment": ("o_comment",
                   "SELECT o_comment, COUNT(*) AS n, SUM(o_totalprice) AS s "
                   f"FROM orders {_ROW_RANGE} GROUP BY o_comment"),
}
ROW_TPCH = ("q3", "q4", "q13")


def row_store_load(cluster, tp, row_tables=("orders",)) -> dict:
    """customer, orders and lineitem into ``cluster``. A table of
    ``row_tables`` is a row table of ``ROW_SHARDS`` shards, loaded in
    INSERT batches of ``ROW_LOAD_BATCH`` rows through the call
    ``Cluster.insert`` makes (``RowTable.insert``: its strings as values,
    encoded into the cluster's dictionaries, which hold the data's
    dictionaries first, in order, so the ids agree); the others are
    column tables (``bulk_load``). Seconds per table."""
    from ydb_tpu_torch.workload import tpch

    s = cluster.session()
    out = {}
    for name in ("customer", "orders", "lineitem"):
        schema = tp.schema(name)
        sql = create_table_sql(name, schema, tpch.PRIMARY_KEYS[name])
        if name in row_tables:
            sql += f" WITH (store = row, shards = {ROW_SHARDS})"
        s.execute(sql)
        cols = tp.tables[name]
        if name not in row_tables:
            out[name] = bulk_load(cluster, name, cols, tp.dicts)
            continue
        t0 = time.perf_counter()
        for f in schema.fields:
            if f.type.is_string:
                d = cluster.dicts.for_column(f.name)
                src = tp.dicts[f.name].values
                if len(d) < len(src):
                    d.encode(list(src[len(d):]))
        values = {k: (np.asarray(tp.dicts[k].values, dtype=object)[v]
                      if schema.field(k).type.is_string else v)
                  for k, v in cols.items()}
        t = cluster.tables[name]
        n = len(next(iter(values.values())))
        for lo in range(0, n, ROW_LOAD_BATCH):
            res = t.insert({k: v[lo:lo + ROW_LOAD_BATCH]
                            for k, v in values.items()})
            assert res.committed, res
        cluster._invalidate_plans()
        out[name] = time.perf_counter() - t0
    return out


def row_statement(cluster, session, sql, cold=False) -> tuple:
    """``sql`` through ``session``; its result, milliseconds, and the
    milliseconds, walks and reuses of the row tables' ``source_at`` in
    it. ``cold`` drops each row table's last source first, so the
    statement walks its rows as it would after a commit."""
    from ydb_tpu_torch.datashard.table import RowTable

    rows = [t for t in cluster.tables.values() if isinstance(t, RowTable)]
    if cold:
        for t in rows:
            t._last_source = None
    s0 = sum(t.source_seconds for t in rows)
    b0 = sum(t.source_builds for t in rows)
    h0 = sum(t.source_hits for t in rows)
    t0 = time.perf_counter()
    res = session.execute(sql)
    ms = (time.perf_counter() - t0) * 1e3
    src_ms = (sum(t.source_seconds for t in rows) - s0) * 1e3
    return res, {"ms": ms, "source_at_ms": src_ms,
                 "source_at_share": src_ms / ms,
                 "source_builds": sum(t.source_builds for t in rows) - b0,
                 "source_hits": sum(t.source_hits for t in rows) - h0}


def by_key(res, key) -> dict:
    """A GROUP BY's columns in ascending key order (without ORDER BY its
    groups may come in any order)."""
    order = np.argsort(np.asarray(res.cols[key][0]), kind="stable")
    return {n: (np.asarray(v)[order].tolist(), np.asarray(ok)[order].tolist())
            for n, (v, ok) in res.cols.items()}


def row_oracle(tp, key):
    """The GROUP BY of ``ROW_GROUP_BYS`` on ``key`` by the port's numpy
    oracle (``engine/oracle.py:run_oracle``) over the host orders."""
    from ydb_tpu_torch import dtypes
    from ydb_tpu_torch.engine.oracle import OracleTable, run_oracle
    from ydb_tpu_torch.ssa import Agg, AggSpec, Call, Col, FilterStep, \
        GroupByStep, Op
    from ydb_tpu_torch.ssa.program import Const, Program

    o = tp.tables["orders"]
    table = OracleTable({k: (np.asarray(v), np.ones(len(v), dtype=bool))
                         for k, v in o.items()}, tp.schema("orders"))
    prog = Program((
        FilterStep(Call(Op.GE, Col("o_orderdate"),
                        Const(tpch_days("1995-01-01"), dtypes.DATE))),
        FilterStep(Call(Op.LT, Col("o_orderdate"),
                        Const(tpch_days("1998-01-01"), dtypes.DATE))),
        GroupByStep(keys=(key,), aggs=(
            AggSpec(Agg.COUNT_ALL, None, "n"),
            AggSpec(Agg.SUM, "o_totalprice", "s"))),
    ))
    return run_oracle(prog, table, tp.dicts)


def check_sql_q4(res, t, dicts):
    o, li = t["orders"], t["lineitem"]
    late = np.zeros(len(o["o_orderkey"]), dtype=bool)
    m = li["l_commitdate"] < li["l_receiptdate"]
    late[li["l_orderkey"][m] - 1] = True
    keep = ((o["o_orderdate"] >= tpch_days("1993-07-01"))
            & (o["o_orderdate"] < tpch_days("1993-10-01")) & late)
    counts = np.bincount(o["o_orderpriority"][keep],
                         minlength=len(dicts["o_orderpriority"]))
    ids = np.flatnonzero(counts)
    names = dicts["o_orderpriority"].decode(ids)
    order = sorted(range(len(ids)), key=lambda i: names[i])
    assert _decoded(res, "o_orderpriority", dicts) == \
        [names[i] for i in order]
    assert np.array_equal(_ints(res, "order_count"), counts[ids][order])


def row_analytics(rc, cc, tp, ck) -> dict:
    """Step 2: the GROUP BYs and TPC-H q3, q4 and q13 over the orders row
    table, first (the row table walked), warm (its source reused) and
    once more under syncsan (nothing built, captured or compiled), the
    GROUP BYs once more on the per-aggregate lowering with fusion off;
    the kernels' launches over these runs; every answer equal to the
    all-column cluster ``cc`` and to numpy; then (not counted) the
    o_comment GROUP BY's kernel calls on both lowerings held against the
    plain versions."""
    from ydb_tpu_torch.analysis import syncsan
    from ydb_tpu_torch.ssa import kernels
    from ydb_tpu_torch.workload.queries import TPCH

    stmts = {name: sql for name, (_k, sql) in ROW_GROUP_BYS.items()}
    stmts.update({q: TPCH[q] for q in ROW_TPCH})
    s = rc.session()
    rows, got = [], {}
    ck.reset_launches()
    with routed() as seen:
        for name, sql in stmts.items():
            got[name], first = row_statement(rc, s, sql, cold=True)
            n_seen = len(seen)
            warm_res, warm = row_statement(rc, s, sql)
            same_result(warm_res, got[name], name + " warm")
            rows.append({"statement": name, "lowering": "default",
                         "path": seen[n_seen] if len(seen) > n_seen
                         else "walk",
                         "rows": got[name].num_rows,
                         "first_ms": first["ms"], "warm_ms": warm["ms"],
                         "source_at_first_ms": first["source_at_ms"],
                         "source_at_warm_ms": warm["source_at_ms"],
                         "source_at_share_first": first["source_at_share"],
                         "source_at_share_warm": warm["source_at_share"],
                         "source_builds_first": first["source_builds"],
                         "source_hits_warm": warm["source_hits"]})
            assert first["source_builds"] == 1, (name, first)
            assert (warm["source_builds"], warm["source_hits"]) == (0, 1), \
                (name, warm)
            # a third, untimed run under syncsan: a warm row-table
            # statement builds, captures and compiles nothing
            with syncsan.activate():
                same_result(s.execute(sql), got[name], name + " armed")
                ss = dict(s.last_profile.syncsan)
            rows[-1]["warm_syncsan"] = ss
            assert ss["captures"] == ss["builds"] == ss["compiles"] == 0, \
                (name, ss)
        kernels.FUSED_FORCE = False
        try:
            with fusion_force(False):
                for name, (key, sql) in ROW_GROUP_BYS.items():
                    res, m = row_statement(rc, s, sql)
                    assert by_key(res, key) == by_key(got[name], key), name
                    rows.append({"statement": name, "lowering": "peragg",
                                 "rows": res.num_rows, "first_ms": m["ms"],
                                 "source_at_first_ms": m["source_at_ms"],
                                 "source_at_share_first":
                                     m["source_at_share"]})
        finally:
            kernels.FUSED_FORCE = None
    launches = dict(ck.LAUNCHES)
    log(f"row store analytics launches: {launches}")
    assert launches["grouped_sum_multi"] > 0 and \
        launches["grouped_sum"] > 0, launches
    check = {}
    sql = ROW_GROUP_BYS["gb_comment"][1]
    try:
        with fusion_force(False):
            for lowering, force, kernel in (
                    ("fused", None, "grouped_sum_multi"),
                    ("peragg", False, "grouped_sum")):
                kernels.FUSED_FORCE = force
                check[f"gb_comment_{lowering}"] = row = \
                    checked_kernel_calls(ck, lambda: s.execute(sql))
                assert row[kernel]["calls"] > 0, (lowering, row)
    finally:
        kernels.FUSED_FORCE = None
    rc._invalidate_plans()
    cs = cc.session()
    for name, sql in stmts.items():
        want = cs.execute(sql)
        if name in ROW_GROUP_BYS:
            key = ROW_GROUP_BYS[name][0]
            assert by_key(got[name], key) == by_key(want, key), name
            assert by_key(got[name], key) == by_key(
                row_oracle(tp, key), key), (name, "oracle")
        else:
            same_result(got[name], want, name)
    for q in ROW_TPCH:
        got[q].dict_aliases = {}  # output strings keep their source names
    check_sql_q3(got["q3"], tp.tables, tp.dicts)
    check_sql_q4(got["q4"], tp.tables, tp.dicts)
    check_sql_q13(got["q13"], tp.tables, tp.dicts)
    for r in rows:
        emit({"row_statement": r})
    log("row store analytics: every answer equals the all-column cluster's "
        "and numpy's")
    return {"statements": rows, "launches": launches, "kernel_check": check,
            "answers": {"gb_comment": by_key(got["gb_comment"],
                                             "o_comment")}}


def transfer_worker(rc, wid, rnd, log_, errors) -> None:
    """One session's TX_PER_ROUND interactive transfers of round ``rnd``,
    each retried until it commits; appends (step, a, b, x) per commit and
    counts aborts into ``log_``."""
    import random

    from ydb_tpu_torch.sql.planner import PlanError

    rng = random.Random(TX_SEED * 1000 + rnd * 10 + wid)
    s = rc.session()
    try:
        for _ in range(TX_PER_ROUND):
            a, b = rng.sample(range(ACCOUNTS), 2)
            x = rng.randrange(1, 100)
            while True:
                try:
                    s.execute("BEGIN")
                    s.execute(f"UPDATE accounts SET balance = balance - {x} "
                              f"WHERE id = {a}")
                    s.execute(f"UPDATE accounts SET balance = balance + {x} "
                              f"WHERE id = {b}")
                    res = s.execute("COMMIT")
                except PlanError as e:  # changed after BEGIN: tx gone
                    assert "changed after BEGIN" in str(e), e
                    with log_["lock"]:
                        log_["first_touch_aborts"] += 1
                    continue
                with log_["lock"]:
                    if res.committed:
                        log_["commits"].append((res.step, a, b, x))
                        break
                    log_["commit_aborts"] += 1
    except BaseException as e:  # noqa: BLE001 - raised by the caller
        errors.append(e)


def row_transactions(rc) -> dict:
    """Step 3: the interleaved transfer workload on ``accounts``; the
    autocommit UPDATE / INSERT / DELETE and the secondary-index lookup;
    SUM(balance) on the card after every round, conserved; the balances
    at the end equal to a serial replay of the committed transfers."""
    import threading

    from ydb_tpu_torch.analysis import syncsan

    s = rc.session()
    s.execute("CREATE TABLE accounts (id BIGINT NOT NULL, branch BIGINT, "
              "balance BIGINT, PRIMARY KEY (id)) WITH (store = row, "
              f"shards = {ACCOUNT_SHARDS})")
    t = rc.tables["accounts"]
    ids = np.arange(ACCOUNTS, dtype=np.int64)
    t0 = time.perf_counter()
    for lo in range(0, ACCOUNTS, ROW_LOAD_BATCH // 4):
        hi = min(lo + ROW_LOAD_BATCH // 4, ACCOUNTS)
        assert t.insert({
            "id": ids[lo:hi], "branch": ids[lo:hi] % ACCOUNT_BRANCHES,
            "balance": np.full(hi - lo, ACCOUNT_START, dtype=np.int64),
        }).committed
    rc._invalidate_plans()
    t.add_index("by_branch", "branch")
    load_s = time.perf_counter() - t0
    total = ACCOUNTS * ACCOUNT_START
    sum_sql = "SELECT SUM(balance) AS s FROM accounts"

    def read_sum() -> int:
        return int(s.execute(sum_sql).cols["s"][0][0])

    sums = [read_sum()]
    assert sums[0] == total, sums
    log_ = {"lock": threading.Lock(), "commits": [], "commit_aborts": 0,
            "first_touch_aborts": 0}
    warm_sum = []
    index = {}
    t_tx = time.perf_counter()
    rounds = 0
    for rnd in range(TX_ROUNDS):
        rounds += 1
        # autocommit writes that keep the sum: a zero-balance account
        # comes, moves to another branch (the index follows), and goes
        k = ACCOUNTS + rnd
        assert s.execute(f"INSERT INTO accounts VALUES ({k}, 7, 0)").committed
        assert s.execute(f"UPDATE accounts SET branch = 8 WHERE id = {k}"
                         ).committed
        assert (k,) in t.lookup_index("by_branch", 8)
        assert (k,) not in t.lookup_index("by_branch", 7)
        assert s.execute(f"DELETE FROM accounts WHERE id = {k}").committed
        assert (k,) not in t.lookup_index("by_branch", 8)
        errors: list = []
        threads = [threading.Thread(target=transfer_worker,
                                    args=(rc, w, rnd, log_, errors))
                   for w in range(TX_SESSIONS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=ROW_STORE_BUDGET_S)
        assert not errors, errors
        assert not any(th.is_alive() for th in threads)
        sums.append(read_sum())
        with syncsan.activate():
            sums.append(read_sum())  # warm: a replay, nothing built
            warm_sum.append(dict(s.last_profile.syncsan))
        assert sums[-1] == sums[-2] == total, sums
    tx_s = time.perf_counter() - t_tx
    for ss in warm_sum:
        assert ss["captures"] == ss["builds"] == ss["compiles"] == 0, ss
    pks = t.lookup_index("by_branch", LOOKUP_BRANCH)
    index["lookup_rows"] = len(pks)
    assert sorted(pks) == [(int(i),) for i in ids
                           if i % ACCOUNT_BRANCHES == LOOKUP_BRANCH]
    rows = t.read_rows(pks)
    assert all(r["branch"] == LOOKUP_BRANCH for r in rows.values())
    commits = sorted(log_["commits"])
    assert len(commits) == TX_SESSIONS * rounds * TX_PER_ROUND
    assert len({c[0] for c in commits}) == len(commits)
    want = np.full(ACCOUNTS, ACCOUNT_START, dtype=np.int64)
    for _step, a, b, x in commits:
        want[a] -= x
        want[b] += x
    res = s.execute("SELECT id, balance FROM accounts ORDER BY id")
    assert np.array_equal(res.cols["id"][0], ids)
    balances = np.asarray(res.cols["balance"][0])
    assert np.array_equal(balances, want)
    aborts = log_["commit_aborts"] + log_["first_touch_aborts"]
    out = {"accounts": ACCOUNTS, "shards": ACCOUNT_SHARDS,
           "load_s": load_s, "sessions": TX_SESSIONS, "rounds": rounds,
           "transfers_committed": len(commits),
           "aborted_at_commit": log_["commit_aborts"],
           "aborted_at_first_touch": log_["first_touch_aborts"],
           "retries": aborts, "transfer_seconds": tx_s,
           "commits_per_s": len(commits) / tx_s,
           "sums": sums, "sum_conserved": all(x == total for x in sums),
           "warm_sum_syncsan": warm_sum, "index": index,
           "balances": balances}
    log(f"row store transfers: {len(commits)} committed, {aborts} aborted "
        f"and retried, {tx_s:.2f} s; SUM(balance) {total} after every "
        "round; balances equal the serial replay")
    return out


def row_store_phase(dev, ck, sf: float = ROW_SF) -> dict:
    """Phase 13 (see the module docstring). Returns every measurement;
    ``launches`` are the kernels' launches of step 2's counted runs."""
    import shutil
    import tempfile

    from ydb_tpu_torch.config import AppConfig
    from ydb_tpu_torch.engine.blobs import DirBlobStore, MemBlobStore
    from ydb_tpu_torch.kqp.session import Cluster
    from ydb_tpu_torch.workload import tpch

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="rowstore_")
    out: dict = {"sf": sf, "row_shards": ROW_SHARDS}
    try:
        t0 = time.perf_counter()
        tp = tpch.TpchData(sf=sf, seed=ROW_SEED)
        out["datagen_s"] = time.perf_counter() - t0
        rc = Cluster(store=DirBlobStore(os.path.join(root, "rows")),
                     device=dev, config=AppConfig())
        load = row_store_load(rc, tp)
        n_orders = len(tp.tables["orders"]["o_orderkey"])
        out["load"] = {"orders_rows": n_orders,
                       "orders_s": load["orders"],
                       "orders_rows_per_s": n_orders / load["orders"],
                       "column_tables_s": load["customer"]
                       + load["lineitem"]}
        log(f"row store load: {n_orders} orders rows into {ROW_SHARDS} "
            f"DataShards in {load['orders']:.2f} s "
            f"({n_orders / load['orders']:.0f} rows/s)")
        cc = Cluster(store=MemBlobStore(), device=dev, config=AppConfig())
        row_store_load(cc, tp, row_tables=())
        out["analytics"] = row_analytics(rc, cc, tp, ck)
        cc.stop()
        del cc
        out["launches"] = out["analytics"].pop("launches")
        out["kernel_check"] = out["analytics"].pop("kernel_check")
        answers = out["analytics"].pop("answers")
        tx = row_transactions(rc)
        balances = tx.pop("balances")
        out["transactions"] = tx
        rc.stop()
        del rc
        # step 4: a new Cluster from the same directory
        t0 = time.perf_counter()
        rb = Cluster(store=DirBlobStore(os.path.join(root, "rows")),
                     device=dev, config=AppConfig())
        boot_s = time.perf_counter() - t0
        s = rb.session()
        key, sql = ROW_GROUP_BYS["gb_comment"]
        assert by_key(s.execute(sql), key) == answers["gb_comment"]
        res = s.execute("SELECT id, balance FROM accounts ORDER BY id")
        assert np.array_equal(np.asarray(res.cols["balance"][0]), balances)
        out["reboot"] = {"boot_s": boot_s, "group_by_equal": True,
                         "balances_equal": True}
        rb.stop()
        del rb
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    emit({"row_store": out})
    log(f"row store phase: {out['seconds']:.1f} s")
    assert out["seconds"] < ROW_STORE_BUDGET_S, out["seconds"]
    return out


# ---------------- phase 17: SQL on a degraded erasure group ----------------

#: phase 17's own time limit, seconds of script time
ERASURE_BUDGET_S = 60.0
#: its data: TPC-H and ClickBench hits, made from ERASURE_SEED (a block-4-2
#: group of a real deployment holds far more: cut for the clock)
ERASURE_SF = 0.1
#: 1<<19 rows keep 1,709 URL groups (the GROUP BY URL still takes the
#: kernel tier, past 512 groups); 1<<20 rows take about twice the phase's
#: time, too close to its budget (PERF.md, section 4)
ERASURE_HITS_ROWS = 1 << 19
ERASURE_SEED = 42
ERASURE_GROUP = 17
#: each PDisk's chunk size. A WAL record holds one part whole, and a
#: block-4-2 part is a quarter of its blob, so a blob up to about 4 x 16 MiB
#: fits; this cell's largest blob is a hits portion (131,072 rows of a
#: 4-shard table, about 16 MB, so parts of about 4 MB; 8 MB at 1<<20 rows)
ERASURE_CHUNK = 16 << 20
#: each LSM hull's memtable: a flush (and a compaction every max_runs + 1
#: flushes, which rewrites the whole hull) comes this many bytes apart
ERASURE_MEMTABLE = 64 << 20
#: the disks taken down: two (the loss block-4-2 tolerates), two others
#: after the controller's heal, then a third beside those
ERASURE_DOWN = (0, 3)
ERASURE_DOWN_HEALED = (1, 4)
ERASURE_THIRD = 2
#: the statement that must fail beyond the quorum and answer after resync
ERASURE_BEYOND_SQL = "q6"
#: ``blob.get`` failpoint: this many faults, then it passes
ERASURE_FAULTS = 2


class MeteredCodec:
    """An ``ErasureCodec`` whose encodes and decodes are counted and timed:
    bytes, calls and seconds, and of the decodes those that rebuilt a
    lost data part (restores). Everything else is the codec's."""

    def __init__(self, codec):
        self.codec = codec
        self.reset()

    def reset(self) -> None:
        self.n = collections.Counter()

    def __getattr__(self, name):
        return getattr(self.codec, name)

    def encode(self, data):
        t0 = time.perf_counter()
        out = self.codec.encode(data)
        self.n["encode_s"] += time.perf_counter() - t0
        self.n["encodes"] += 1
        self.n["encode_bytes"] += len(data)
        return out

    def decode(self, parts, orig_len):
        t0 = time.perf_counter()
        out = self.codec.decode(parts, orig_len)
        dt = time.perf_counter() - t0
        self.n["decodes"] += 1
        self.n["decode_bytes"] += len(out)
        self.n["decode_s"] += dt
        if any(i not in parts for i in range(self.codec.data_parts)):
            self.n["restores"] += 1
            self.n["restore_bytes"] += len(out)
            self.n["restore_s"] += dt
        return out


def metered_group_store(proxy):
    """A ``GroupBlobStore`` over ``proxy`` that counts what it hands back:
    whole gets, ranged gets, their bytes and the blobs read. Its
    ``get_range`` is ``BlobStore.get_range``'s: the whole blob, sliced."""
    from ydb_tpu_torch.blobstorage import GroupBlobStore

    class Metered(GroupBlobStore):
        def reset(self) -> None:
            self.n = collections.Counter()
            self.blobs: set = set()

        def get(self, blob_id):
            data = self.proxy.get(blob_id)
            self.n["gets"] += 1
            self.n["returned_bytes"] += len(data)
            self.blobs.add(blob_id)
            return data

        def get_range(self, blob_id, off, length):
            data = self.proxy.get(blob_id)[off:off + length]
            self.n["ranged_gets"] += 1
            self.n["returned_bytes"] += len(data)
            self.blobs.add(blob_id)
            return data

    store = Metered(proxy)
    store.reset()
    return store


def erasure_disk(root, name, written, made):
    """A VDisk ``name`` on an LSM hull on its own PDisk file under
    ``root``; the PDisk's chunk writes are summed into ``written``, the
    PDisk appended to ``made``."""
    from ydb_tpu_torch.blobstorage import VDisk
    from ydb_tpu_torch.blobstorage.pdisk import PDisk
    from ydb_tpu_torch.blobstorage.vdisk_lsm import LsmBlobStore

    pd = PDisk(os.path.join(root, name), chunk_size=ERASURE_CHUNK)
    made.append(pd)
    real = pd.write

    def write(chunk_id, offset, data):
        written[name] += len(data)
        real(chunk_id, offset, data)

    pd.write = write
    return VDisk(name, backing=LsmBlobStore(
        pd, memtable_bytes=ERASURE_MEMTABLE))


def lsm_live_bytes(lsm) -> int:
    """The bytes an LSM hull holds live (newest version of each key)."""
    seen = {k: (len(v) if v is not None else 0) for k, v in lsm.mem.items()}
    for run in lsm.runs:
        for key, _ci, _off, ln, is_del in run["index"]:
            seen.setdefault(key, 0 if is_del else ln)
    return sum(seen.values())


def drop_device_tiers(cluster) -> None:
    """Empty the cluster's scan block cache and every column shard's
    block cache and resident tier, so the next scan reads the store."""
    cluster.scan_block_cache.clear()
    for t in cluster.tables.values():
        for sh in getattr(t, "shards", ()):
            for tier in ("resident", "block_cache"):
                cache = getattr(sh, tier, None)
                if cache is not None:
                    cache.clear()


def erasure_boot(store, dev):
    from ydb_tpu_torch.config import AppConfig
    from ydb_tpu_torch.kqp.session import Cluster

    t0 = time.perf_counter()
    cluster = Cluster(store=store, device=dev, config=AppConfig())
    return cluster, time.perf_counter() - t0


def erasure_statements(cluster, only=None) -> dict:
    """TPC-H Q1, Q6 and q3 under the default routing, and q33 and q36
    (GROUP BY URL) on the fused lowering (``kernels.FUSED_FORCE`` True)
    and on the per-aggregate one (False); results and milliseconds."""
    from ydb_tpu_torch.ssa import kernels
    from ydb_tpu_torch.workload import clickbench
    from ydb_tpu_torch.workload.queries import TPCH

    stmts = [(q, TPCH[q], None) for q in ("q1", "q6", "q3")]
    stmts += [(f"{q}_{low}", clickbench.QUERIES[q], force)
              for low, force in (("fused", True), ("peragg", False))
              for q in ("q33", "q36")]
    s = cluster.session()
    got, ms = {}, {}
    for name, sql, force in stmts:
        if only is not None and name not in only:
            continue
        kernels.FUSED_FORCE = force
        try:
            t0 = time.perf_counter()
            got[name] = s.execute(sql)
            ms[name] = (time.perf_counter() - t0) * 1e3
        finally:
            kernels.FUSED_FORCE = None
    return {"results": got, "ms": ms}


def check_erasure_answers(got, tp, cb) -> None:
    """Step 2's answers against numpy: Q1, Q6 and q3 by the SQL phase's
    checks, q33 and q36 on both lowerings by ``q33_q36_answers``."""
    from ydb_tpu_torch.workload import clickbench

    li = tp.tables["lineitem"]
    for q in ("q1", "q3"):
        got[q].dict_aliases = {}  # output strings keep their source names
    check_sql_q1(got["q1"], li, tp.dicts)
    check_sql_q6(got["q6"], li)
    check_sql_q3(got["q3"], tp.tables, tp.dicts)
    answers = clickbench.q33_q36_answers(cb)
    for name, col in (("q33", "c"), ("q36", "pv")):
        for low in ("fused", "peragg"):
            r = got[f"{name}_{low}"]
            pairs = list(zip(cb.dicts["URL"].decode(r.cols["URL"][0]),
                             (int(x) for x in r.cols[col][0])))
            assert pairs == answers[name], (name, low, pairs[:3])


def degraded_writes(cluster) -> tuple:
    """COUNT and SUM(v) of the table phase 17 writes while disks are
    down."""
    res = cluster.session().execute(
        "SELECT count(*) AS n, sum(v) AS s FROM degraded_writes")
    return int(res.cols["n"][0][0]), int(res.cols["s"][0][0])


def same_answers(got, want, label) -> None:
    for name, res in got.items():
        same_result(res, want[name], f"{label} {name}")


def reopen_hulls(group, root, written, made) -> float:
    """Every live disk's LSM hull closed and opened again from its PDisk
    file alone (manifest, then WAL replay); seconds."""
    t0 = time.perf_counter()
    for disk in group.disks:
        if disk.down:
            continue
        disk.backing.pdisk.close()
        disk.backing = erasure_disk(root, disk.disk_id, written,
                                    made).backing
    return time.perf_counter() - t0


def read_meter(codec, store) -> dict:
    n, s = codec.n, store.n
    return {"decodes": n["decodes"], "decode_bytes": n["decode_bytes"],
            "decode_s": n["decode_s"], "restores": n["restores"],
            "restore_bytes": n["restore_bytes"],
            "restore_s": n["restore_s"],
            "restore_mb_per_s": (n["restore_bytes"] / 1e6 / n["restore_s"]
                                 if n["restore_s"] else None),
            "gets": s["gets"], "ranged_gets": s["ranged_gets"],
            "returned_bytes": s["returned_bytes"],
            "blobs_read": len(store.blobs),
            "read_amplification": (n["decode_bytes"] / s["returned_bytes"]
                                   if s["returned_bytes"] else None),
            "decodes_per_blob_read": (n["decodes"] / len(store.blobs)
                                      if store.blobs else None)}


def erasure_phase(dev, ck, sf: float = ERASURE_SF,
                  hits_rows: int = ERASURE_HITS_ROWS) -> dict:
    """Phase 17 (see the module docstring). On the CPU (a rehearsal,
    ``ck`` None) no kernel is counted or checked."""
    import shutil
    import tempfile

    from ydb_tpu_torch.blobstorage import DSProxy, GroupInfo
    from ydb_tpu_torch.blobstorage.controller import BSController, NodeWarden
    from ydb_tpu_torch.runtime.failpoints import (FailpointBlobStore,
                                                  Failpoints, InjectedFault)
    from ydb_tpu_torch.workload import clickbench, tpch

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="erasure_")
    written: collections.Counter = collections.Counter()
    made: list = []
    steps: dict = {}
    out: dict = {"sf": sf, "hits_rows": hits_rows, "chunk_bytes":
                 ERASURE_CHUNK, "memtable_bytes": ERASURE_MEMTABLE}
    clusters: list = []

    def step(name, t0):
        steps[name] = time.perf_counter() - t0
        log(f"erasure step {name}: {steps[name]:.2f} s")

    def boot():
        c, s = erasure_boot(store, dev)
        clusters.append(c)
        return c, s

    def stop(c):
        c.stop()
        clusters.remove(c)

    try:
        # ---- step 1: the group, the controller, the load ----
        t0 = time.perf_counter()
        tp = tpch.TpchData(sf=sf, seed=ERASURE_SEED)
        cb = clickbench.ClickBenchData(rows=hits_rows, seed=ERASURE_SEED)
        out["datagen_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        group = GroupInfo(ERASURE_GROUP, "block42", [
            erasure_disk(root, f"g{ERASURE_GROUP}-d{i}", written, made)
            for i in range(6)])
        proxy = DSProxy(group)
        codec = proxy.codec = MeteredCodec(proxy.codec)
        store = metered_group_store(proxy)
        ctl = BSController()
        ctl.register_group(proxy)
        warden = NodeWarden(1)
        spares = [erasure_disk(root, f"g{ERASURE_GROUP}-spare{i}", written,
                               made) for i in range(2)]
        for disk in spares:
            warden.register_spare(disk)
        ctl.register_warden(warden)
        cluster, _ = boot()
        s = cluster.session()
        raw = rows = 0
        tables = [(t, cols, tp.schema(t), tpch.PRIMARY_KEYS[t], tp.dicts)
                  for t, cols in tp.tables.items()]
        tables.append(("hits", cb.hits, clickbench.HITS_SCHEMA,
                       ("WatchID",), cb.dicts))
        for name, cols, schema, pk, dicts in tables:
            s.execute(create_table_sql(name, schema, pk))
            bulk_load(cluster, name, cols, dicts)
            raw += sum(np.asarray(v).nbytes for v in cols.values())
            rows += len(next(iter(cols.values())))
        for disk in group.disks:
            disk.backing.flush()
        load_s = time.perf_counter() - t0
        live = {d.disk_id: lsm_live_bytes(d.backing) for d in group.disks}
        out["load"] = {
            "rows": rows, "raw_bytes": raw, "seconds": load_s,
            "rows_per_s": rows / load_s, "live_bytes": live,
            "live_over_raw": sum(live.values()) / raw,
            "written_bytes": dict(written),
            "written_over_raw": sum(written.values()) / raw,
            "encodes": codec.n["encodes"],
            "encode_bytes": codec.n["encode_bytes"],
            "encode_s": codec.n["encode_s"],
            "encode_mb_per_s": codec.n["encode_bytes"] / 1e6
            / codec.n["encode_s"],
            "largest_part": max(ln for d in group.disks
                                for run in d.backing.runs
                                for _k, _c, _o, ln, _d in run["index"]),
            "blobs": len(proxy.list(""))}
        log(f"erasure load: {rows} rows ({raw} raw bytes) into a block-4-2 "
            f"group in {load_s:.2f} s ({rows / load_s:.0f} rows/s); live "
            f"bytes per disk {live}; live / raw "
            f"{out['load']['live_over_raw']:.3f}, PDisk chunk bytes written "
            f"/ raw {out['load']['written_over_raw']:.3f}; encode "
            f"{out['load']['encode_mb_per_s']:.1f} MB/s; largest part "
            f"{out['load']['largest_part']} bytes of a {ERASURE_CHUNK}-byte "
            f"chunk")
        step("load", t_phase)

        # ---- step 2: healthy ----
        t0 = time.perf_counter()
        assert cluster.health() == {"status": "GOOD", "issues": []}
        if cuda:
            ck.reset_launches()
        healthy = erasure_statements(cluster)
        want = healthy["results"]
        if cuda:
            out["launches"] = dict(ck.LAUNCHES)
            log(f"erasure launches (Q1, Q6, q3, then q33 and q36 on both "
                f"lowerings): {out['launches']}")
            assert all(v > 0 for v in out["launches"].values()), \
                out["launches"]
        check_erasure_answers(want, tp, cb)
        if cuda:
            out["kernel_check"] = serving_kernels(cluster, ck)
        out["healthy_ms"] = healthy["ms"]
        step("healthy", t0)

        # ---- step 3: degraded ----
        t0 = time.perf_counter()
        for i in ERASURE_DOWN:
            group.disks[i].down = True
        h = cluster.health()
        assert h == {"status": "DEGRADED", "issues": [{
            "severity": "yellow",
            "message": f"group {ERASURE_GROUP}: {len(ERASURE_DOWN)} "
                       f"disk(s) down"}]}, h
        stop(cluster)
        out["reopen_s"] = reopen_hulls(group, root, written, made)
        codec.reset()
        store.reset()
        cluster, out["degraded_boot_s"] = boot()
        degraded = erasure_statements(cluster)
        same_answers(degraded["results"], want, "degraded")
        out["degraded_read"] = read_meter(codec, store)
        out["degraded_ms"] = degraded["ms"]
        s = cluster.session()
        s.execute("CREATE TABLE degraded_writes (id int64, v int64, "
                  "PRIMARY KEY (id))")
        s.execute("INSERT INTO degraded_writes VALUES (1, 10), (2, 20), "
                  "(3, 30)")
        assert degraded_writes(cluster) == (3, 60)
        m = out["degraded_read"]
        log(f"erasure degraded (disks {ERASURE_DOWN} down): boot "
            f"{out['degraded_boot_s']:.2f} s, answers equal step 2's; "
            f"restore {m['restore_mb_per_s']} MB/s over {m['restores']} "
            f"restores; {m['decode_bytes']} bytes decoded for "
            f"{m['returned_bytes']} returned (x{m['read_amplification']}), "
            f"{m['decodes_per_blob_read']} decodes per blob read")
        step("degraded", t0)

        # ---- step 4: the controller heals; two other disks go ----
        t0 = time.perf_counter()
        healed = ctl.check_and_heal()
        out["heal"] = [{"slot": r.slot, "old": r.old_disk, "new": r.new_disk,
                        "parts_rebuilt": r.parts_rebuilt} for r in healed]
        assert sorted(r.slot for r in healed) == sorted(ERASURE_DOWN), \
            out["heal"]
        assert ctl.degraded_groups() == [] and warden.spare_count == 0
        assert cluster.health() == {"status": "GOOD", "issues": []}
        out["heal_s"] = time.perf_counter() - t0
        for i in ERASURE_DOWN_HEALED:
            group.disks[i].down = True
        stop(cluster)
        cluster, out["healed_boot_s"] = boot()
        same_answers(erasure_statements(cluster)["results"], want, "healed")
        # a write while disks 1 and 4 are down, for step 5's resync
        cluster.session().execute(
            "INSERT INTO degraded_writes VALUES (4, 40)")
        assert degraded_writes(cluster) == (4, 100)
        step("heal", t0)

        # ---- step 5: beyond the quorum, then back and resync ----
        t0 = time.perf_counter()
        group.disks[ERASURE_THIRD].down = True
        h = cluster.health()
        assert h["status"] == "EMERGENCY", h
        assert {"severity": "red",
                "message": f"group {ERASURE_GROUP}: 3 disk(s) down"} \
            in h["issues"], h
        drop_device_tiers(cluster)
        try:
            erasure_statements(cluster, only=(ERASURE_BEYOND_SQL,))
            raise AssertionError(f"{ERASURE_BEYOND_SQL} answered with three "
                                 f"disks of a block-4-2 group down")
        except (ValueError, KeyError) as e:
            out["beyond_quorum_error"] = f"{type(e).__name__}: {e}"
        log(f"erasure beyond the quorum: health {h}; "
            f"{ERASURE_BEYOND_SQL} raised {out['beyond_quorum_error']}")
        for i in (*ERASURE_DOWN_HEALED, ERASURE_THIRD):
            group.disks[i].down = False
        out["resync_parts"] = proxy.resync()
        assert out["resync_parts"] > 0, out["resync_parts"]
        drop_device_tiers(cluster)
        res = erasure_statements(cluster, only=(ERASURE_BEYOND_SQL,))
        same_answers(res["results"], want, "resynced")
        assert degraded_writes(cluster) == (4, 100)
        assert cluster.health() == {"status": "GOOD", "issues": []}
        stop(cluster)
        step("beyond_quorum", t0)

        # ---- step 6: failpoints ----
        t0 = time.perf_counter()
        fp = Failpoints()
        faulty = FailpointBlobStore(store, fp)
        fp.arm("blob.get", "times", ERASURE_FAULTS)
        faults = []
        for _ in range(ERASURE_FAULTS + 1):
            try:
                c, _ = erasure_boot(faulty, dev)
                break
            except InjectedFault as e:
                faults.append(str(e))
        else:
            raise AssertionError(f"every boot failed: {faults}")
        clusters.append(c)
        res = erasure_statements(c, only=("q33_fused",))
        same_answers(res["results"], want, "failpoints")
        stop(c)
        out["failpoints"] = {"faults": faults, "stats": fp.stats("blob.get")}
        assert len(faults) == ERASURE_FAULTS, faults
        assert out["failpoints"]["stats"]["fired"] == ERASURE_FAULTS
        log(f"erasure failpoints: blob.get {fp.stats('blob.get')}; "
            f"{len(faults)} boots failed soft, then q33 equal step 2's")
        step("failpoints", t0)
    finally:
        for c in clusters:
            c.stop()
        for pd in made:
            pd.close()
        shutil.rmtree(root, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["steps_s"] = steps
    emit({"erasure": out})
    log(f"erasure phase: {out['seconds']:.1f} s")
    assert out["seconds"] < ERASURE_BUDGET_S, out["seconds"]
    return out


def tpch_days(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor (default 10)")
    ap.add_argument("--sql-sf", type=float, default=None,
                    help="TPC-H scale factor of the SQL phase (default: "
                    "--sf, reusing the scan phase's tables)")
    ap.add_argument("--hits-rows", type=int, default=10_000_000,
                    help="ClickBench hits rows (published: 99997497)")
    ap.add_argument("--json-out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--dq-warm", type=int, default=None,
                    help="warm runs per query in the DQ phase, each query "
                    "also profiled, whatever the time (default: 3, or 1 "
                    f"where the first run took over {DQ_SLOW_FIRST_S} s, "
                    f"while the run stays under {DQ_EXTRAS_BUDGET_S} s)")
    ap.add_argument("--tpcds-sf", type=float, default=TPCDS_SF,
                    help=f"TPC-DS scale of phase 8 (default {TPCDS_SF})")
    ap.add_argument("--storage-sql-sf", type=float, default=STORAGE_SQL_SF,
                    help="TPC-H scale of phase 9's SQL over sharded tables "
                    f"(default {STORAGE_SQL_SF})")
    ap.add_argument("--serving-sf", type=float, default=SERVING_SF,
                    help="TPC-H scale of phase 10's serving path "
                    f"(default {SERVING_SF})")
    ap.add_argument("--row-sf", type=float, default=ROW_SF,
                    help="TPC-H scale of phase 13's row store "
                    f"(default {ROW_SF})")
    ap.add_argument("--baseline-source", default=None,
                    help="an earlier grouped_sum.cu with the zero-filled-"
                    "output interface, timed beside the kernels in the "
                    "same run (see load_baseline)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from ydb_tpu_torch.engine.scan import ColumnSource
    from ydb_tpu_torch.ssa import cuda_kernels as ck
    from ydb_tpu_torch.ssa import kernels
    from ydb_tpu_torch.workload import clickbench, tpch

    dev = torch.device("cuda", 0)
    clock = PhaseClock()
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; {smi}")
    report: dict = {"device": kind, "nvidia_smi": smi}

    # ---- phase 2 ----
    max_err = kernel_phase(ck, dev)
    clock.lap("2_kernels")

    # ---- phase 3: stage data ----
    t0 = time.perf_counter()
    tp = tpch.TpchData(sf=args.sf, seed=42)
    li = tp.tables["lineitem"]
    n_li = len(li["l_orderkey"])
    li_src = ColumnSource(li, tpch.LINEITEM_SCHEMA, tp.dicts)
    (ex1, ex6), li_blocks, li_stage_s = stage(
        li_src, (tpch.q1_program(), tpch.q6_program()), dev)
    log(f"TPC-H sf={args.sf}: {n_li} lineitem rows generated+staged in "
        f"{time.perf_counter() - t0:.1f} s ({len(li_blocks)} blocks; "
        f"staging {li_stage_s:.2f} s)")
    t0 = time.perf_counter()
    cb = clickbench.ClickBenchData(rows=args.hits_rows, seed=42)
    cb_src = ColumnSource(cb.hits, clickbench.HITS_SCHEMA, cb.dicts)
    (ex33, ex36), cb_blocks, cb_stage_s = stage(
        cb_src, (clickbench.q33_program(), clickbench.q36_program()), dev)
    log(f"ClickBench: {args.hits_rows} hits rows generated+staged in "
        f"{time.perf_counter() - t0:.1f} s ({len(cb_blocks)} blocks; "
        f"URL dictionary {len(cb.dicts['URL'])}; q33 layout "
        f"{ex33.partial.group_layout})")
    assert ex33.partial.group_layout == ("dense", len(cb.dicts["URL"]) + 1)

    runs = [
        ("q1", ex1, li_blocks, None),
        ("q6", ex6, li_blocks, None),
        ("q33_fused", ex33, cb_blocks, True),
        ("q36_fused", ex36, cb_blocks, True),
        ("q33_peragg", ex33, cb_blocks, False),
        ("q36_peragg", ex36, cb_blocks, False),
    ]

    def drive(ex, blocks, fused):
        kernels.FUSED_FORCE = fused
        try:
            out = ex.run_stream(blocks)
            torch.cuda.synchronize()
            return out
        finally:
            kernels.FUSED_FORCE = None

    # ---- phase 3: the main path, counted ----
    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launches()
    outs, per_query = {}, {}
    for name, ex, blocks, fused in runs:
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        outs[name] = drive(ex, blocks, fused)
        per_query[name] = {
            "seconds": time.perf_counter() - t0,
            "launches": {k: ck.LAUNCHES[k] - before[k] for k in before}}
    launches = dict(ck.LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    log(f"main path peak device memory: {peak_bytes} bytes (staged blocks "
        "included)")
    log(f"main path launches: {launches}; per query: "
        + json.dumps({k: v["launches"] for k, v in per_query.items()}))
    for name in ("q33_fused", "q36_fused"):
        assert per_query[name]["launches"]["grouped_sum_multi"] > 0, name
    for name in ("q33_peragg", "q36_peragg"):
        assert per_query[name]["launches"]["grouped_sum"] > 0, name
    assert all(v > 0 for v in launches.values()), launches

    # ---- phase 3: results ----
    from ydb_tpu_torch.engine.oracle import OracleTable

    res = {k: OracleTable.from_block(v) for k, v in outs.items()}
    want1 = numpy_q1(li, tpch._days("1998-12-01") - 90)
    check_q1(res["q1"], want1)
    want6 = numpy_q6(li, tpch._days("1994-01-01"), tpch._days("1995-01-01"))
    assert res["q6"].num_rows == 1
    assert int(res["q6"].cols["revenue"][0][0]) == want6
    answers = clickbench.q33_q36_answers(cb)
    for name, col in (("q33_fused", "c"), ("q36_fused", "pv"),
                      ("q33_peragg", "c"), ("q36_peragg", "pv")):
        r = res[name]
        got = list(zip(cb.dicts["URL"].decode(r.cols["URL"][0]),
                       (int(x) for x in r.cols[col][0])))
        assert got == answers[name[:3]], (name, got[:3])
    log("main path results: Q1/Q6 equal numpy (ints exact, averages rtol "
        "1e-12); q33/q36 fused and per-aggregate equal the numpy answers")

    clock.lap("3_main_path")

    # ---- phase 4: warm timings ----
    metrics, warm_runs = {}, {}
    for name, ex, blocks, fused in runs:
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            drive(ex, blocks, fused)
            ts.append(time.perf_counter() - t0)
        n = n_li if name in ("q1", "q6") else args.hits_rows
        metrics[f"{name}_warm_rows_per_s"] = n / statistics.median(ts)
        metrics[f"{name}_warm_s"] = statistics.median(ts)
        warm_runs[name] = ts
    log("warm: " + json.dumps(metrics))
    log("warm runs, seconds each: " + json.dumps(warm_runs))

    # per-kernel time at the main path's shape: one 1<<20-row block of
    # q33, group ids = dense URL slots (zipf-skewed), int32 count values
    ng = len(cb.dicts["URL"]) + 1
    url = torch.from_numpy(cb.hits["URL"][:BLOCK_ROWS]).to(dev)
    g = (url + 1).to(torch.int32)
    rows = g.shape[0]
    idx64 = g.long()
    ones = torch.ones(rows, dtype=torch.int32, device=dev)
    ones2 = ones[:, None].contiguous()
    buf = torch.zeros(ng + 1, dtype=torch.int32, device=dev)
    buf2 = torch.zeros(ng + 1, 1, dtype=torch.int32, device=dev)
    baseline = (load_baseline(ck, args.baseline_source)
                if args.baseline_source else None)
    kernel_rows = []
    for name, kfn, pfn, lfn, vals in (
        ("grouped_sum_multi", ck.grouped_sum_multi, ck.grouped_sum_multi_plain,
         lambda: buf2.index_add_(0, idx64, ones2), ones2),
        ("grouped_sum", ck.grouped_sum, ck.grouped_sum_plain,
         lambda: buf.index_add_(0, idx64, ones), ones),
    ):
        slots = 1 if vals.ndim == 1 else vals.shape[1]
        bound_ms, bound_by = bound(rows, slots, ng)
        # one call, one device launch: no fill or memset beside the kernel
        issued = device_kernels_of_one_call(lambda: kfn(vals, g, ng))
        assert len(issued) == 1 and "grouped_sum_kernel" in issued[0], issued
        # plain, kernel, kernel, plain: compare within one call
        p1, k1, k2, p2 = (device_ms(f) for f in (
            lambda: pfn(vals, g, ng), lambda: kfn(vals, g, ng),
            lambda: kfn(vals, g, ng), lambda: pfn(vals, g, ng)))
        sets = cold_sets((vals, g), vals.nbytes + g.nbytes)
        cold = device_ms([(lambda vv=vv, gg=gg: kfn(vv, gg, ng))
                          for vv, gg in sets])
        lib = device_ms(lfn)
        call = time_ms(lambda: kfn(vals, g, ng))
        row = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": statistics.median([k1, k2]),
            "plain_ms": statistics.median([p1, p2]),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib,
            "cold_ms": cold, "bound_share": bound_ms / cold,
            "call_ms": call, "device_ops_per_call": issued,
        }
        msg = (f"{name} @ rows={rows} groups={ng} slots={slots}: device time "
               f"kernel {k1:.5f}/{k2:.5f} ms, cold {cold:.5f} ms, plain "
               f"{p1:.5f}/{p2:.5f} ms, index_add_ {lib:.5f} ms, bound "
               f"{bound_ms:.5f} ms ({bound_ms / cold:.3f} of it cold); "
               f"host-inclusive kernel call {call:.5f} ms; one call issues "
               f"{issued}")
        if baseline:
            bfn = baseline[name]
            assert torch.equal(bfn(vals, g, ng), pfn(vals, g, ng)), name
            b1, b2 = (device_ms(lambda: bfn(vals, g, ng)) for _ in range(2))
            row["baseline_ms"] = statistics.median([b1, b2])
            row["baseline_cold_ms"] = device_ms(
                [(lambda vv=vv, gg=gg: bfn(vv, gg, ng)) for vv, gg in sets])
            row["baseline_device_ops_per_call"] = device_kernels_of_one_call(
                lambda: bfn(vals, g, ng))
            row["baseline_call_ms"] = time_ms(lambda: bfn(vals, g, ng))
            msg += (f"; baseline {b1:.5f}/{b2:.5f} ms, cold "
                    f"{row['baseline_cold_ms']:.5f} ms, host-inclusive call "
                    f"{row['baseline_call_ms']:.5f} ms, one call issues "
                    f"{row['baseline_device_ops_per_call']}")
        del sets
        kernel_rows.append(row)
        log(msg)
    sweep_rows = sweep(ck, baseline, g, ng, dev)
    metrics["q33_fused_launches_per_run"] = per_query["q33_fused"]["launches"]
    metrics["q33_peragg_launches_per_run"] = per_query["q33_peragg"]["launches"]

    clock.lap("4_timings")

    # ---- phase 5: the SQL path ----
    del li_blocks, cb_blocks, outs, ex1, ex6, ex33, ex36, runs
    torch.cuda.empty_cache()
    exceptions = golden_check(dev)
    sql_tp = (tp if args.sql_sf in (None, args.sf)
              else tpch.TpchData(sf=args.sql_sf, seed=42))
    sql_rows, db, catalog, checks, walk = sql_phase(
        sql_tp, dev, ck, (want1, want6) if sql_tp is tp else None)
    sql_launches = {k: sum(r["launches"][k] for r in sql_rows)
                    for k in ck.LAUNCHES}
    log(f"SQL path (walk): 22 queries at sf {sql_tp.sf} on the card; Q1, "
        f"Q3, Q5, Q6, Q13, Q18 equal numpy; CUDA kernel launches over all "
        f"first runs {sql_launches}")
    clock.lap("5_sql")

    # ---- phase 6: the DQ stage graph ----
    dq_golden = dq_golden_check(dev)
    dq_rows = dq_phase(sql_tp, db, catalog, dev, ck, walk,
                       {k: checks[k] for k in ("q3", "q5", "q13", "q18")},
                       args.dq_warm)
    walk_median = {r["query"]: r["warm_median_s"] for r in sql_rows}
    timed = [r for r in dq_rows if r["warm_median_s"] is not None]
    for r in timed:
        r["walk_warm_median_s"] = walk_median[r["query"]]
        r["dq_over_walk"] = r["warm_median_s"] / walk_median[r["query"]]
    dq_launches = {k: sum(r["launches"][k] for r in dq_rows)
                   for k in ck.LAUNCHES}
    log(f"SQL path (DQ): 22 queries at sf {sql_tp.sf} on the card, 20 "
        f"through the DQ stage graph; every result equals the walk's; Q3, "
        f"Q5, Q13, Q18 equal numpy; CUDA kernel launches over all first "
        f"runs {dq_launches}; first runs summed "
        f"{sum(r['first_s'] for r in dq_rows):.4f} s; warm and profiled "
        f"runs made for {len(timed)} queries (DQ_EXTRAS_BUDGET_S), their "
        f"warm medians DQ / walk summed "
        f"{sum(r['warm_median_s'] for r in timed):.4f} / "
        f"{sum(walk_median[r['query']] for r in timed):.4f} s")
    del db, walk
    torch.cuda.empty_cache()
    clock.lap("6_dq")

    # ---- phase 7: whole-plan fusion ----
    fusion = fusion_phase(dev, ck)
    clock.lap("7_fusion")

    # ---- phase 8: TPC-DS ----
    tpcds_rows = tpcds_phase(dev, ck, args.tpcds_sf)
    clock.lap("8_tpcds")

    # ---- phase 9: the ColumnShard storage path ----
    import shutil

    storage = storage_phase(dev, ck, tp, cb, args.storage_sql_sf,
                            (want1, want6), keep_root=True)
    chaos_answers = {"q1": want1,
                     "q33": clickbench.q33_q36_answers(cb)["q33"]}
    del cb
    torch.cuda.empty_cache()
    clock.lap("9_storage")
    roots = [storage.pop("root")]
    try:
        # ---- phase 10: the session and serving plane ----
        serving = serving_phase(dev, ck, args.serving_sf, keep_root=True)
        roots.append(serving.pop("root"))
        serving_root = os.path.join(roots[-1], "main")
        want = serving.pop("sanitize_want")
        clock.lap("10_serving")

        # ---- phase 11: the sanitizers ----
        sanitize = sanitize_phase(dev, ck, serving_root, tp, want,
                                  serving.pop("sanitize_disarmed"))
        del tp
        torch.cuda.empty_cache()
        clock.lap("11_sanitize")

        # ---- phase 12: chaos and the timeline ----
        chaos = chaos_phase(dev, ck, roots[0], serving_root, chaos_answers,
                            want)
        clock.lap("12_chaos")

        # ---- phase 14: monitoring, coordination and load ----
        monitor = monitor_phase(dev, ck, serving_root, want,
                                serving["tpch_table_rows"])
        clock.lap("14_monitor")

        # ---- phase 15: the gRPC front; phase 16 goes on on its node ----
        node = grpc_boot(serving_root, dev)
        try:
            grpc_out = grpc_phase(dev, ck, node, want,
                                  serving["tpch_table_rows"])
        except BaseException:
            stop_node(node)
            raise
        clock.lap("15_grpc")

        # ---- phase 16: streaming ----
        stream = stream_phase(dev, ck, node, serving_root)
        clock.lap("16_stream")
    finally:
        for root in roots:
            shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- phase 13: the row store ----
    row_store = row_store_phase(dev, ck, args.row_sf)
    clock.lap("13_row_store")

    # ---- phase 17: SQL on a degraded erasure group ----
    erasure = erasure_phase(dev, ck)
    clock.lap("17_erasure")
    for row in kernel_rows:
        row["sql_launches"] = sql_launches[row["name"]]
        row["dq_launches"] = dq_launches[row["name"]]
        row["fused_launches"] = fusion["kernel_launches"][row["name"]]
        row["storage_launches"] = storage["launches"][row["name"]]
        row["serving_launches"] = serving["launches"][row["name"]]
        row["sanitize_launches"] = sanitize["launches"][row["name"]]
        row["chaos_launches"] = chaos["resident"]["launches"][row["name"]]
        row["chaos_checked_calls"] = sum(
            q[row["name"]]["calls"]
            for q in chaos["resident"]["kernel_check"].values())
        row["kernelbench_launches"] = \
            chaos["kernelbench"]["group_by"]["launches"][row["name"]]
        row["row_store_launches"] = row_store["launches"][row["name"]]
        row["row_store_checked_calls"] = sum(
            q[row["name"]]["calls"]
            for q in row_store["kernel_check"].values())
        row["sanitize_checked_calls"] = sum(
            q[row["name"]]["calls"]
            for q in sanitize["kernel_check"].values())
        row["serving_checked_calls"] = sum(
            q[row["name"]]["calls"]
            for q in serving["kernel_check"].values())
        row["monitor_launches"] = monitor["launches"][row["name"]]
        row["monitor_checked_calls"] = sum(
            q[row["name"]]["calls"]
            for q in monitor["kernel_check"].values())
        row["grpc_launches"] = grpc_out["launches"][row["name"]]
        row["grpc_checked_calls"] = sum(
            q[row["name"]]["calls"]
            for q in grpc_out["kernel_check"].values())
        row["stream_launches"] = stream["launches"][row["name"]]
        row["stream_checked_calls"] = sum(
            q[row["name"]]["calls"]
            for q in stream["kernel_check"].values())
        row["erasure_launches"] = erasure["launches"][row["name"]]
        row["erasure_checked_calls"] = sum(
            q[row["name"]]["calls"]
            for q in erasure["kernel_check"].values())
        row["max_abs_err"] = max(row["max_abs_err"], *(
            q[row["name"]]["max_abs_err"]
            for q in (*serving["kernel_check"].values(),
                      *sanitize["kernel_check"].values(),
                      *chaos["resident"]["kernel_check"].values(),
                      *monitor["kernel_check"].values(),
                      *grpc_out["kernel_check"].values(),
                      *stream["kernel_check"].values(),
                      *row_store["kernel_check"].values(),
                      *erasure["kernel_check"].values())))

    report.update(metrics=metrics, warm_runs=warm_runs, per_query=per_query,
                  kernels=kernel_rows, sweep=sweep_rows,
                  peak_device_bytes=peak_bytes,
                  sf=args.sf, lineitem_rows=n_li, hits_rows=args.hits_rows,
                  sql=sql_rows, sql_sf=sql_tp.sf,
                  sql_golden_float_exceptions=exceptions,
                  sql_dq=dq_rows, sql_dq_golden=dq_golden, fusion=fusion,
                  tpcds=tpcds_rows, storage=storage, serving=serving,
                  sanitize=sanitize, chaos=chaos, monitor=monitor,
                  grpc=grpc_out, stream=stream, row_store=row_store,
                  erasure=erasure, phase_seconds=clock.seconds)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    log(f"host gauge: phase 4's warm Q1 at sf {args.sf} "
        f"{metrics['q1_warm_s']:.4f} s; whole script "
        f"{time.perf_counter() - STARTED:.1f} s")
    log("chip_smoke: all phases passed")
    print(json.dumps({"phase_seconds": clock.seconds}))
    print(json.dumps({"metrics": metrics}))
    print(json.dumps({"kernels": kernel_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
