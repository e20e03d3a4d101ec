"""gRPC server: the node front door.

Mirror of the reference's gRPC request proxy + per-service impls
(grpc_request_proxy.h:30, ydb/services/ydb; SURVEY.md §2.12): each RPC
routes through one request proxy (auth hook + per-call dispatch) into
the in-process service set (Cluster). Method handlers are registered
generically against the protobuf messages, so no grpc_tools codegen is
needed — protoc generates the messages, grpc carries them.

The port's own copy of ``ydb_tpu/api/server.py`` over the port's
``Cluster``: the same services, method paths and messages (the message
module is kept in the repo, ``api/_gen``; nothing runs ``protoc``), so
the clients of either package drive it. Statements go through the
cluster's sessions as pgwire's do, so tenant admission, the quoter gate
and ``device.work_lock`` apply; the server serves whatever device the
``Cluster`` is on. The Topic service (``Write``, ``Read``, ``Commit``,
``StreamRead``, ``StreamWrite``) serves ``Cluster.topics`` as the
reference's does, and the KeyValue service serves volumes of the port's
``KeyValueTablet`` on the cluster's store under the reference's registry
keys (``kv/volumes/<name>``) and tablet ids (``kvvol/<name>``), so a
volume written through either package's server boots in the other.
Where the reference clears only the plan cache after a bulk
write, the port drops cached plans and compiled programs together
(``Cluster._invalidate_plans``), as its own INSERT does: both bake
dictionary contents in.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from concurrent import futures

import grpc
import numpy as np

from ydb_tpu_torch import serving
from ydb_tpu_torch.analysis import leaksan
from ydb_tpu_torch.api.build import ensure_protos
from ydb_tpu_torch.api.arrow_io import oracle_to_ipc
from ydb_tpu_torch.engine.oracle import OracleTable
from ydb_tpu_torch.kqp.session import Cluster
from ydb_tpu_torch.tx.coordinator import TxResult

pb = ensure_protos()


class RequestProxy:
    """Auth + dispatch front (grpc_request_proxy analog). Tokens: when
    ``auth_tokens`` is set, every call must carry metadata
    ('x-ydb-auth-ticket', <token>)."""

    def __init__(self, cluster: Cluster,
                 auth_tokens: set[str] | None = None):
        self.cluster = cluster
        self.auth_tokens = auth_tokens
        # bounded LRU of server-side sessions: evicting the oldest
        # caps memory against clients that never DeleteSession
        self.sessions: "OrderedDict[str, object]" = OrderedDict()
        self.max_sessions = 1024
        self._next_session = itertools.count(1)
        # leak-sanitizer handle per server-side session (serving.conn):
        # closed by _drop_session, so an eviction/delete/close path
        # that forgets a session fails the drain assertion
        self._conn_leaks: dict[str, object] = {}
        # Cluster/tablet state is not thread-safe: every mutating entry
        # point (RPC handlers AND the serve loop's run_background)
        # serializes on this lock
        self.lock = threading.Lock()
        self.endpoints: tuple = ()
        # long-running operations (Operation service)
        self._operations: dict = {}
        self._op_lock = threading.Lock()
        self._op_seq = 0
        # KeyValue volumes (booted on access from the durable registry)
        self._kv_volumes: dict = {}

    def check_auth(self, context) -> str | None:
        """Validates the ticket; returns it (the ACL principal) when
        auth is on, None for open clusters."""
        if self.auth_tokens is None:
            return None
        md = dict(context.invocation_metadata())
        ticket = md.get("x-ydb-auth-ticket")
        if ticket in self.auth_tokens:
            return ticket
        context.abort(grpc.StatusCode.UNAUTHENTICATED, "bad ticket")
        return None

    # ---- Query ----

    def _resolve_tenant(self, context, principal):
        """Connection metadata -> workload pool: an explicit
        'x-ydb-tenant' header wins, else the principal's registry
        binding, else the default pool (serving/tenants.py)."""
        try:
            md = dict(context.invocation_metadata())
        except Exception:  # noqa: BLE001 - metadata-less test contexts
            md = {}
        return serving.resolve_tenant(
            self.cluster, tenant=md.get("x-ydb-tenant"),
            principal=principal)

    def create_session(self, request, context):
        principal = self.check_auth(context)
        tenant = self._resolve_tenant(context, principal)
        with self.lock:
            sid = f"session-{next(self._next_session)}"
            session = self.cluster.session()
            session.principal = principal
            session.tenant = tenant
            self.sessions[sid] = session
            lk = leaksan.track("serving.conn", f"grpc:{tenant}")
            if lk is not None:
                self._conn_leaks[sid] = lk
            while len(self.sessions) > self.max_sessions:
                old_sid, _ = next(iter(self.sessions.items()))
                self._drop_session(old_sid)
        return pb.CreateSessionResponse(session_id=sid)

    def _drop_session(self, session_id: str) -> None:
        """Remove a server-side session; an open interactive tx rolls
        back first so its shard locks never leak (the hazard
        execute_script's finally block guards against)."""
        s = self.sessions.pop(session_id, None)
        if self._conn_leaks:
            leaksan.close(self._conn_leaks.pop(session_id, None))
        if s is not None and getattr(s, "_tx", None) is not None:
            s._tx_release()
            s._api_tx_id = None

    def _owned_session(self, session_id, principal, context):
        """Session ids are guessable; a ticket may only drive sessions
        it created (no cross-principal ACL identity borrowing)."""
        session = self.sessions.get(session_id)
        if session is not None and session.principal != principal:
            context.abort(grpc.StatusCode.PERMISSION_DENIED,
                          "session belongs to another principal")
        return session

    def delete_session(self, request, context):
        principal = self.check_auth(context)
        with self.lock:
            if self._owned_session(request.session_id, principal,
                                   context) is not None:
                self._drop_session(request.session_id)
        return pb.DeleteSessionResponse()

    def execute_query(self, request, context):
        principal = self.check_auth(context)
        session = self._owned_session(request.session_id, principal,
                                      context)
        if session is None:
            session = self.cluster.session()  # sessionless query
            session.principal = principal
            session.tenant = self._resolve_tenant(context, principal)
        try:
            # reads outside an open transaction skip the single-writer
            # lock: concurrent clients' SELECTs co-occupy the batch
            # window (kqp/batch.py) instead of serializing here
            if getattr(session, "_tx", None) is None \
                    and serving.is_read_statement(request.sql):
                out = session.execute(request.sql)
            else:
                with self.lock:
                    out = session.execute(request.sql)
        except Exception as e:  # noqa: BLE001 - surface to the client
            return pb.ExecuteQueryResponse(
                status=pb.ExecuteQueryResponse.ERROR, error=str(e))
        resp = pb.ExecuteQueryResponse(
            status=pb.ExecuteQueryResponse.SUCCESS)
        if out is None:  # DDL: no result set, no tx step
            resp.committed = True
        elif isinstance(out, str):  # EXPLAIN: the rendered plan
            resp.plan_text = out
        elif isinstance(out, OracleTable):
            # out.dicts is the per-result view the session bound (alias
            # -> source dictionary), not the raw cluster set
            resp.arrow_ipc = oracle_to_ipc(out)
        elif isinstance(out, TxResult):
            resp.tx_step = out.step
            resp.committed = out.committed
            if not out.committed:
                resp.status = pb.ExecuteQueryResponse.ERROR
                resp.error = out.error or "not committed"
        return resp

    # ---- Scheme ----

    def list_directory(self, request, context):
        self.check_auth(context)
        path = request.path or "/"
        if not self.cluster.scheme.exists(path):
            return pb.ListDirectoryResponse(error=f"no path {path}")
        children = []
        for child in self.cluster.scheme.children(path):
            children.append(pb.SchemeEntry(
                path=child, kind=self.cluster.scheme.kind(child)))
        return pb.ListDirectoryResponse(children=children)

    def describe_table(self, request, context):
        self.check_auth(context)
        desc = self.cluster.scheme.describe(request.path)
        if desc is None:
            return pb.DescribeTableResponse(
                error=f"{request.path} is not a table")
        from ydb_tpu_torch.scheme.model import type_to_str

        return pb.DescribeTableResponse(
            path=desc.path,
            columns=[pb.ColumnMeta(name=f.name, type=type_to_str(f.type),
                                   nullable=f.nullable)
                     for f in desc.schema.fields],
            primary_key=list(desc.primary_key),
            shards=desc.n_shards,
            store=desc.store,
            schema_version=desc.schema_version,
        )

    # ---- Topic ----

    def _topic(self, name: str):
        return self.cluster.topics.get(name)

    def topic_write(self, request, context):
        self.check_auth(context)
        topic = self._topic(request.topic)
        if topic is None:
            return pb.TopicWriteResponse(
                error=f"no topic {request.topic}")
        with self.lock:
            p, off = topic.write(
                request.data.decode("utf-8", "surrogateescape"),
                key=request.key or None,
                producer=request.producer or None,
                seqno=request.seqno if request.producer else None,
            )
        return pb.TopicWriteResponse(partition=p, offset=off)

    def topic_read(self, request, context):
        self.check_auth(context)
        topic = self._topic(request.topic)
        if topic is None:
            return pb.TopicReadResponse(error=f"no topic {request.topic}")
        with self.lock:
            reader = topic.reader(request.consumer)
            msgs = reader.read_batch(request.limit or 100)
        return pb.TopicReadResponse(messages=[
            pb.TopicMessage(
                partition=m["partition"], offset=m["offset"],
                data=m["data"].encode("utf-8", "surrogateescape"))
            for m in msgs
        ])

    def topic_stream_read(self, request, context):
        """Server-streaming read session (the persqueue_v1 read-session
        analog): batches stream as data arrives; session-local read
        positions start at the committed offsets, so two sessions of one
        consumer do not double-deliver within themselves; auto_commit
        durably advances the consumer."""
        import time as _t

        self.check_auth(context)
        pos: dict[int, int] = {}
        idle_ms = request.idle_timeout_ms
        max_batch = request.max_batch or 100
        last_data = _t.monotonic()
        pending_commit: list[dict] = []
        while context.is_active():
            batch = []
            error = None
            with self.lock:
                topic = self._topic(request.topic)
                if topic is None:
                    error = f"no topic {request.topic}"
                else:
                    if pending_commit and request.auto_commit:
                        # commit the PREVIOUS batch only now that its
                        # yield completed: a disconnect mid-transfer
                        # must not lose committed-but-undelivered rows
                        topic.reader(request.consumer).commit_batch(
                            pending_commit)
                        pending_commit = []
                    for pi, part in enumerate(topic.partitions):
                        start = pos.get(
                            pi, part.committed(request.consumer))
                        if part.head_offset <= start:
                            pos[pi] = start  # idle partition: no scan
                            continue
                        for m in part.read(start, max_batch):
                            batch.append(dict(m, partition=pi))
                            start = m["offset"] + 1
                        pos[pi] = start
            # NEVER yield while holding the lock: a slow client's flow
            # control would wedge every RPC on the node
            if error is not None:
                yield pb.TopicReadResponse(error=error)
                return
            if batch:
                last_data = _t.monotonic()
                yield pb.TopicReadResponse(messages=[
                    pb.TopicMessage(
                        partition=m["partition"], offset=m["offset"],
                        data=m["data"].encode("utf-8",
                                              "surrogateescape"))
                    for m in batch
                ])
                pending_commit = batch
            else:
                if idle_ms and (_t.monotonic() - last_data) * 1000 > \
                        idle_ms:
                    break
                _t.sleep(0.02)
        # graceful end: the final delivered batch commits too
        if pending_commit and request.auto_commit:
            with self.lock:
                topic = self._topic(request.topic)
                if topic is not None:
                    topic.reader(request.consumer).commit_batch(
                        pending_commit)

    def topic_stream_write(self, request_iterator, context):
        """Bidirectional write session: one ack per item, producer
        seqno dedup exactly as unary writes."""
        self.check_auth(context)
        for item in request_iterator:
            ack = None
            with self.lock:
                topic = self._topic(item.topic)
                if topic is None:
                    ack = pb.StreamWriteAck(
                        error=f"no topic {item.topic}")
                else:
                    try:
                        p, off = topic.write(
                            item.data.decode("utf-8", "surrogateescape"),
                            key=item.key or None,
                            producer=item.producer or None,
                            seqno=item.seqno if item.producer else None,
                        )
                        ack = pb.StreamWriteAck(partition=p, offset=off)
                    except Exception as e:  # noqa: BLE001
                        ack = pb.StreamWriteAck(error=str(e))
            # yield outside the lock (slow-client flow control)
            yield ack

    def topic_commit(self, request, context):
        self.check_auth(context)
        topic = self._topic(request.topic)
        if topic is None:
            return pb.TopicCommitResponse(
                error=f"no topic {request.topic}")
        if not 0 <= request.partition < len(topic.partitions):
            return pb.TopicCommitResponse(
                error=f"partition {request.partition} out of range")
        with self.lock:
            topic.partitions[request.partition].commit(
                request.consumer, request.offset + 1)
        return pb.TopicCommitResponse()

    # ---- KeyValue service (ydb_keyvalue_v1 analog over the KeyValue
    # tablet: volumes live in the cluster store, reboot-durable) ----

    def _kv_registered(self, path: str) -> bool:
        """Exact-key registry probe (a prefix listing would make
        volume 'a' shadow 'ab'). The reference reads the key and catches
        ``KeyError``, which a ``DirBlobStore`` never raises (it raises
        ``FileNotFoundError``), so its service creates no volume on a
        directory store; the port asks the store (ROADMAP.md queue C)."""
        return self.cluster.store.exists(f"kv/volumes/{path}")

    def _kv_volume(self, path: str):
        """Boot-on-access from the durable registry: a proxy restart
        loses nothing."""
        from ydb_tpu_torch.tablet.keyvalue import KeyValueTablet

        if path in self._kv_volumes:
            return self._kv_volumes[path]
        if not self._kv_registered(path):
            return None
        vol = KeyValueTablet.boot(f"kvvol/{path}", self.cluster.store)
        self._kv_volumes[path] = vol
        return vol

    def kv_create_volume(self, request, context):
        self.check_auth(context)
        from ydb_tpu_torch.tablet.keyvalue import KeyValueTablet

        if "/" in request.path or not request.path:
            return pb.KvVolumeResponse(
                error="volume names must be non-empty and '/'-free "
                      "(they key the tablet store)")
        with self.lock:
            if self._kv_registered(request.path):
                return pb.KvVolumeResponse(
                    error=f"volume {request.path} exists")
            self.cluster.store.put(f"kv/volumes/{request.path}", b"1")
            self._kv_volumes[request.path] = KeyValueTablet.boot(
                f"kvvol/{request.path}", self.cluster.store)
        return pb.KvVolumeResponse()

    def kv_drop_volume(self, request, context):
        self.check_auth(context)
        with self.lock:
            vol = self._kv_volume(request.path)
            if vol is None:
                return pb.KvVolumeResponse(
                    error=f"no volume {request.path}")
            vol.delete_range(None, None)
            self.cluster.store.delete(f"kv/volumes/{request.path}")
            self._kv_volumes.pop(request.path, None)
        return pb.KvVolumeResponse()

    def kv_write(self, request, context):
        self.check_auth(context)
        with self.lock:
            vol = self._kv_volume(request.volume)
            if vol is None:
                return pb.KvWriteResponse(
                    error=f"no volume {request.volume}")
            vol.write(request.key, request.value)
        return pb.KvWriteResponse()

    def kv_read(self, request, context):
        self.check_auth(context)
        with self.lock:
            vol = self._kv_volume(request.volume)
            if vol is None:
                return pb.KvReadResponse(
                    error=f"no volume {request.volume}")
            v = vol.read(request.key)
        if v is None:
            return pb.KvReadResponse(found=False)
        return pb.KvReadResponse(found=True, value=v)

    def kv_list_range(self, request, context):
        self.check_auth(context)
        with self.lock:
            vol = self._kv_volume(request.volume)
            if vol is None:
                return pb.KvListRangeResponse(
                    error=f"no volume {request.volume}")
            pairs = vol.read_range(getattr(request, "from") or None,
                                   request.to or None,
                                   limit=request.limit or 1000)
        return pb.KvListRangeResponse(pairs=[
            pb.KvPair(key=k, value=v) for k, v in pairs])

    def kv_delete_range(self, request, context):
        self.check_auth(context)
        with self.lock:
            vol = self._kv_volume(request.volume)
            if vol is None:
                return pb.KvDeleteRangeResponse(
                    error=f"no volume {request.volume}")
            n = vol.delete_range(getattr(request, "from") or None,
                                 request.to or None)
        return pb.KvDeleteRangeResponse(deleted=n)

    def kv_rename(self, request, context):
        self.check_auth(context)
        with self.lock:
            vol = self._kv_volume(request.volume)
            if vol is None:
                return pb.KvRenameResponse(
                    error=f"no volume {request.volume}")
            ok = vol.rename(request.old_key, request.new_key)
        return pb.KvRenameResponse(renamed=ok)

    # ---- Export/Import (ydb_export/ydb_import analog) ----

    def _run_export(self, table: str, name: str) -> dict:
        from ydb_tpu_torch.engine.backup import export_table
        from ydb_tpu_torch.tx import ShardedTable

        # the export streams under the cluster lock: portion metadata
        # is not safe to read concurrently with locked writers
        # (compaction/GC under run_background), and the miniature
        # prefers a stalled RPC to a torn read
        with self.lock:
            t = self.cluster.tables.get(table)
            if t is None:
                raise ValueError(f"unknown table {table}")
            if not isinstance(t, ShardedTable):
                raise ValueError("export supports column-store tables")
            return export_table(t, self.cluster.store, name or table)

    def export_backup(self, request, context):
        self.check_auth(context)
        if request.async_op:
            op_id = self._start_operation(
                "export", self._run_export, request.table,
                request.name)
            return pb.ExportResponse(operation_id=op_id)
        try:
            man = self._run_export(request.table, request.name)
        except ValueError as e:
            return pb.ExportResponse(error=str(e))
        return pb.ExportResponse(rows=man["rows"],
                                 parts=len(man["parts"]),
                                 snapshot=man["snapshot"])

    def execute_script(self, request, context):
        """Multi-statement script in ONE session (ydb_scripting shape):
        statements run in order, the script aborts at the first error
        (pg simple-query semantics), and the final SELECT's result
        ships back as arrow IPC."""
        principal = self.check_auth(context)
        session = self.cluster.session()
        session.principal = principal
        results = []
        last_ipc = b""
        try:
            for stmt in _split_script(request.script):
                try:
                    with self.lock:
                        out = session.execute(stmt)
                except Exception as e:  # noqa: BLE001 - abort script
                    results.append(pb.ScriptStatementResult(
                        sql=stmt[:128], error=str(e)))
                    return pb.ExecuteScriptResponse(
                        error=f"{stmt[:64]}: {e}", statements=results)
                if isinstance(out, TxResult) and not out.committed:
                    # a failed COMMIT raises nothing — it reports; the
                    # script must still abort, not claim success
                    err = out.error or "not committed"
                    results.append(pb.ScriptStatementResult(
                        sql=stmt[:128], error=err))
                    return pb.ExecuteScriptResponse(
                        error=f"{stmt[:64]}: {err}",
                        statements=results)
                if isinstance(out, OracleTable):
                    rows = out.num_rows
                    last_ipc = oracle_to_ipc(out)
                else:
                    rows = 0
                results.append(pb.ScriptStatementResult(
                    sql=stmt[:128], rows=rows))
        finally:
            tx_open = session._tx is not None
            if tx_open:
                # an open interactive tx would silently drop buffered
                # writes AND leak its shard locks: roll it back
                with self.lock:
                    session._tx_release()
        if tx_open:
            return pb.ExecuteScriptResponse(
                error="script ended with an open transaction "
                      "(rolled back)", statements=results)
        return pb.ExecuteScriptResponse(statements=results,
                                        last_result_ipc=last_ipc)

    # ---- Operation service (long-running ops, ydb_operation analog) --

    def _start_operation(self, kind: str, fn, *args) -> str:
        with self._op_lock:
            self._op_seq += 1
            op_id = f"op-{self._op_seq}"
            st = {"id": op_id, "kind": kind, "ready": False,
                  "error": "", "result": None}
            self._operations[op_id] = st
            # bounded like the session map: forget the oldest FINISHED
            # ops so clients that never CancelOperation cannot grow
            # memory without limit
            if len(self._operations) > 1024:
                for old_id in [k for k, v in self._operations.items()
                               if v["ready"]][:len(self._operations)
                                              - 1024]:
                    del self._operations[old_id]

        seat = leaksan.track("serving.seat", f"op:{kind}")

        def run():
            try:
                st["result"] = fn(*args)
            except Exception as e:  # noqa: BLE001 - surfaced on poll
                st["error"] = str(e)
            finally:
                # the handoff ends HERE: drop the thread object and
                # the seat before publishing ready, so finished op
                # records never strand a Thread (they used to pin one
                # each until the record aged past the 1024 bound) and
                # the sanitizer sees the seat drain when the work
                # drains — even if fn dies on a BaseException
                with self._op_lock:
                    st.pop("thread", None)
                leaksan.close(seat)
                st["ready"] = True

        # the handle rides in the op record so close() can join
        # stragglers instead of abandoning them at process exit
        t = threading.Thread(target=run, daemon=True,
                             name=f"op-{kind}")
        st["thread"] = t
        try:
            t.start()
        except BaseException:
            # the seat's owner is the thread; if it never launched,
            # the spawn path must drain what it tracked
            with self._op_lock:
                st.pop("thread", None)
            leaksan.close(seat)
            raise
        return op_id

    def close(self, timeout: float = 10.0) -> None:
        """Join outstanding operation threads and drop every
        server-side session (orderly shutdown path: serve() callers
        should close the proxy after stopping gRPC, before
        Cluster.stop — which asserts all serving.* handles drained)."""
        with self._op_lock:
            threads = [st.get("thread") for st in
                       self._operations.values()]
        for t in threads:
            if t is not None and t.is_alive():
                t.join(timeout=timeout)
        with self.lock:
            for sid in list(self.sessions):
                self._drop_session(sid)

    def _op_status(self, st) -> "pb.OperationStatus":
        rows = 0
        if st["ready"] and st["result"] is not None:
            rows = st["result"].get("rows", 0)
        return pb.OperationStatus(id=st["id"], ready=st["ready"],
                                  error=st["error"], rows=rows,
                                  kind=st["kind"])

    def get_operation(self, request, context):
        self.check_auth(context)
        with self._op_lock:
            st = self._operations.get(request.id)
        if st is None:
            return pb.OperationStatus(id=request.id,
                                      error="unknown operation")
        return self._op_status(st)

    def list_operations(self, request, context):
        self.check_auth(context)
        with self._op_lock:
            sts = list(self._operations.values())
        return pb.ListOperationsResponse(
            operations=[self._op_status(st) for st in sts])

    def cancel_operation(self, request, context):
        """Forget a finished operation (running exports hold the
        cluster lock and complete; cancellation is bookkeeping, as for
        most of the reference's non-cancellable op kinds)."""
        self.check_auth(context)
        with self._op_lock:
            st = self._operations.get(request.id)
            if st is None:
                return pb.OperationStatus(id=request.id,
                                          error="unknown operation")
            if st["ready"]:
                del self._operations[request.id]
                return self._op_status(st)
        return pb.OperationStatus(id=request.id,
                                  error="operation still running")

    def import_backup(self, request, context):
        """Restore a backup as a CLUSTER table: scheme entry created,
        string ids remapped from the manifest's dictionaries into the
        cluster-shared set, rows streamed through the normal insert
        path (so WAL/portions/dedup semantics all apply)."""
        self.check_auth(context)
        from ydb_tpu_torch.engine.backup import read_manifest, schema_from_json
        from ydb_tpu_torch.engine.portion import read_portion_blob
        from ydb_tpu_torch.scheme.model import TableDescription
        from ydb_tpu_torch.scheme.shard import SchemeError

        with self.lock:
            c = self.cluster
            try:
                man = read_manifest(c.store, request.name)
            except KeyError:
                return pb.ImportResponse(
                    error=f"no backup {request.name}")
            target = request.table or man["name"]
            if target in c.tables:
                return pb.ImportResponse(
                    error=f"table {target} already exists")
            schema = schema_from_json(man["schema"])
            desc = TableDescription(
                path="/" + target, schema=schema,
                primary_key=(man["pk_column"],),
                n_shards=request.shards or man["n_shards"],
                store="column", ttl_column=man.get("ttl_column"),
                upsert=man["upsert"],
            )
            try:
                c.scheme.create_table(desc)
            except SchemeError as e:
                return pb.ImportResponse(error=str(e))
            try:
                t = c._instantiate(desc)
                # remap manifest dictionary ids -> cluster-shared ids
                remap: dict[str, np.ndarray] = {}
                for col, values in man["dicts"].items():
                    d = c.dicts.for_column(col)
                    remap[col] = np.array(
                        [d.add(v.encode("latin1")) for v in values],
                        dtype=np.int32)
                rows = 0
                for part in man["parts"]:
                    cols, valid = read_portion_blob(c.store,
                                                    part["blob_id"])
                    for col in list(cols):
                        if col in remap and \
                                schema.field(col).type.is_string:
                            cols[col] = remap[col][cols[col]]
                    t.insert(cols, valid or None)
                    rows += part["rows"]
            except Exception as e:  # noqa: BLE001 - import must not
                # leave a half-populated table registered: roll the DDL
                # back so a retry does not hit "already exists"
                t2 = c.tables.pop(target, None)
                c.primary_keys.pop(target, None)
                prefixes = t2.storage_prefixes() if t2 is not None \
                    else []
                try:
                    c.scheme.drop_table("/" + target,
                                        trash_prefixes=prefixes)
                    c._sweep_trash()
                except Exception:  # noqa: BLE001 - keep first error
                    pass
                return pb.ImportResponse(error=f"import failed: {e}")
            c._invalidate_plans()
        return pb.ImportResponse(rows=rows)

    def list_backups(self, request, context):
        self.check_auth(context)
        import json as _json

        out = []
        with self.lock:
            for blob_id in self.cluster.store.list("backup/"):
                if not blob_id.endswith("/manifest"):
                    continue
                man = _json.loads(self.cluster.store.get(blob_id))
                out.append(pb.BackupInfo(name=man["name"],
                                         rows=man["rows"],
                                         snapshot=man["snapshot"]))
        return pb.ListBackupsResponse(backups=out)

    # ---- RateLimiter (ydb_rate_limiter analog over runtime.quoter) ----

    def _quoter(self):
        from ydb_tpu_torch.runtime.quoter import Quoter

        if self.cluster.quoter is None:
            self.cluster.quoter = Quoter()
        return self.cluster.quoter

    def create_resource(self, request, context):
        self.check_auth(context)
        if request.rate <= 0:
            return pb.CreateResourceResponse(error="rate must be > 0")
        with self.lock:
            q = self._quoter()
            if q.exists(request.path):
                # re-creating would refill the bucket to full burst — a
                # throttled client could defeat its own limit
                return pb.CreateResourceResponse(
                    error=f"resource {request.path} already exists")
            q.configure(request.path, request.rate,
                        request.burst if request.burst > 0 else None)
        return pb.CreateResourceResponse()

    def acquire_resource(self, request, context):
        self.check_auth(context)
        amount = request.amount or 1.0
        with self.lock:
            q = self._quoter()
            if q.describe(request.path) is None and not any(
                    q.exists(p) for p in _ancestors(request.path)):
                return pb.AcquireResourceResponse(
                    error=f"no resource {request.path}")
            ok = q.try_acquire(request.path, amount)
            retry = 0.0 if ok else q.wait_time(request.path, amount)
        return pb.AcquireResourceResponse(acquired=ok,
                                          retry_after_s=retry)

    def describe_resource(self, request, context):
        self.check_auth(context)
        with self.lock:
            desc = self._quoter().describe(request.path)
        if desc is None:
            return pb.DescribeResourceResponse(
                error=f"no resource {request.path}")
        return pb.DescribeResourceResponse(
            rate=desc["rate"], burst=desc["burst"],
            tokens=desc["tokens"])

    # ---- Monitoring (ydb_monitoring analog over obs.sysview) ----

    def health_check(self, request, context):
        self.check_auth(context)
        with self.lock:
            h = self.cluster.health()
        return pb.HealthCheckResponse(
            status=h["status"],
            issues=[pb.HealthIssue(message=i["message"],
                                   component=i.get("component", ""),
                                   severity=i.get("severity", ""))
                    for i in h.get("issues", [])])

    # ---- Coordination (kesus sessions + semaphores) ----

    def _kesus(self):
        if getattr(self.cluster, "_coord_kesus", None) is None:
            from ydb_tpu_torch.tablet.kesus import KesusTablet

            self.cluster._coord_kesus = KesusTablet(
                "coordination", self.cluster.store)
        k = self.cluster._coord_kesus
        # sweep expired sessions on every access: a dead client's
        # semaphore holds release at its timeout, not never
        k.tick()
        return k

    def coord_session(self, request, context):
        self.check_auth(context)
        with self.lock:
            sid = self._kesus().attach_session(
                timeout_s=request.timeout_s or 30.0)
        return pb.CoordSessionResponse(session_id=sid)

    def coord_create_semaphore(self, request, context):
        self.check_auth(context)
        if request.limit < 0:
            return pb.CoordSemaphoreResponse(
                error="limit must be positive")
        try:
            with self.lock:
                self._kesus().create_semaphore(
                    request.name, int(request.limit) or 1)
        except Exception as e:  # noqa: BLE001
            return pb.CoordSemaphoreResponse(error=str(e))
        return pb.CoordSemaphoreResponse()

    def coord_acquire(self, request, context):
        self.check_auth(context)
        if request.count < 0:
            # a negative hold would INCREASE capacity for everyone else
            return pb.CoordSemaphoreResponse(
                error="count must be positive")
        try:
            with self.lock:
                ok = self._kesus().acquire(
                    request.session_id, request.name,
                    count=int(request.count) or 1,
                    timeout_s=request.timeout_s or 0.0)
        except Exception as e:  # noqa: BLE001
            return pb.CoordSemaphoreResponse(error=str(e))
        return pb.CoordSemaphoreResponse(acquired=bool(ok))

    def coord_release(self, request, context):
        self.check_auth(context)
        try:
            with self.lock:
                self._kesus().release(request.session_id, request.name)
        except Exception as e:  # noqa: BLE001
            return pb.CoordSemaphoreResponse(error=str(e))
        return pb.CoordSemaphoreResponse()

    def coord_describe(self, request, context):
        self.check_auth(context)
        try:
            with self.lock:
                d = self._kesus().describe(request.name)
        except KeyError:
            return pb.CoordSemaphoreResponse(
                error=f"no semaphore {request.name}")
        except Exception as e:  # noqa: BLE001
            return pb.CoordSemaphoreResponse(error=str(e))
        return pb.CoordSemaphoreResponse(
            count=sum(d.get("owners", {}).values()),
            limit=d.get("limit", 0),
            waiters=[int(w) for w in d.get("waiters", [])],
            owners=[int(o) for o in d.get("owners", {})])

    def coord_ping(self, request, context):
        self.check_auth(context)
        with self.lock:
            ok = self._kesus().ping_session(request.session_id)
        return pb.CoordSessionResponse(
            session_id=request.session_id,
            error="" if ok else "unknown session")

    def coord_detach(self, request, context):
        self.check_auth(context)
        with self.lock:
            self._kesus().detach_session(request.session_id)
        return pb.CoordSessionResponse(session_id=request.session_id)

    # ---- Cms (dynamic config over runtime.console) ----

    def _console(self):
        if getattr(self.cluster, "console", None) is None:
            from ydb_tpu_torch.runtime.console import Console

            self.cluster.console = Console(self.cluster.store)
            # accepted configs must APPLY, not just persist: a
            # subscriber pushes the resolved knobs into the running
            # cluster (the ConfigsDispatcher contract)
            proxy = self

            class _Apply:
                # Console._notify calls subscriber._deliver(console)
                # (the ConfigsDispatcher contract)
                def _deliver(self, _console):
                    proxy._apply_config()

            self.cluster.console.subscribe(_Apply())
        return self.cluster.console

    def _apply_config(self):
        cfg = self.cluster.console.resolve()
        self.cluster.n_shards = cfg.n_shards
        self.cluster.icb.set("compact_portion_threshold",
                             cfg.compact_portion_threshold)
        self.cluster.icb.set("split_rows_per_shard",
                             cfg.split_rows_per_shard)

    def cms_get_config(self, request, context):
        self.check_auth(context)
        with self.lock:
            yaml_text, ver = self._console().get_config()
        return pb.GetConfigResponse(yaml=yaml_text or "", version=ver)

    def cms_set_config(self, request, context):
        self.check_auth(context)
        try:
            with self.lock:
                expect = (None if request.expect_version == -1
                          else int(request.expect_version))
                ver = self._console().set_config(
                    request.yaml, expected_version=expect)
        except Exception as e:  # noqa: BLE001
            return pb.SetConfigResponse(error=str(e))
        return pb.SetConfigResponse(version=ver)

    # ---- Auth ----

    def who_am_i(self, request, context):
        principal = self.check_auth(context)
        return pb.WhoAmIResponse(user=principal or "",
                                 authenticated=principal is not None)

    # ---- Discovery ----

    def list_endpoints(self, request, context):
        self.check_auth(context)
        return pb.ListEndpointsResponse(endpoints=[
            pb.EndpointInfo(address=a, port=p)
            for a, p in self.endpoints
        ])

    # ---- FederationDiscovery (ydb_federation_discovery_v1 analog) ----

    def list_federation_databases(self, request, context):
        """A single-database cluster reports itself as the whole
        federation (the reference's non-federated deployments answer
        the same way)."""
        self.check_auth(context)
        ep = (f"{self.endpoints[0][0]}:{self.endpoints[0][1]}"
              if self.endpoints else "")
        return pb.ListFederationDatabasesResponse(
            self_location="local",
            databases=[pb.FederationDatabaseInfo(
                name="/local", endpoint=ep, status="AVAILABLE")])

    # ---- Table service (ydb_table_v1 analog: structured DDL, tx
    # control, BulkUpsert, streaming ReadTable) ----

    def _ddl_ast(self):
        from ydb_tpu_torch.sql import ast as sqlast
        return sqlast

    def _acl_session(self, principal):
        """Principal-bound session: its _check_access enforces path
        ACLs exactly as the SQL front door does (principal=None is the
        ACL-exempt internal case, so every handler that acts for a
        client must bind the ticket)."""
        s = self.cluster.session()
        s.principal = principal
        return s

    def _acl_denied(self, principal, *checks) -> str:
        """checks: (perm, path) pairs; returns the denial message for
        the response's error field, or '' when allowed."""
        s = self._acl_session(principal)
        try:
            for perm, path in checks:
                s._check_access(perm, path)
        except Exception as e:  # noqa: BLE001
            return str(e)
        return ""

    def table_create(self, request, context):
        principal = self.check_auth(context)
        denied = self._acl_denied(principal,
                                  ("ddl", "/" + request.path))
        if denied:
            return pb.CreateTableResponse(error=denied)
        sqlast = self._ddl_ast()
        opts = []
        if request.store:
            opts.append(("store", request.store))
        if request.shards:
            opts.append(("shards", str(request.shards)))
        stmt = sqlast.CreateTable(
            table=request.path,
            columns=tuple((c.name, c.type, c.not_null)
                          for c in request.columns),
            primary_key=tuple(request.primary_key),
            options=tuple(opts))
        try:
            with self.lock:
                self.cluster.create_table(stmt)
        except Exception as e:  # noqa: BLE001 - surface to the client
            return pb.CreateTableResponse(error=str(e))
        return pb.CreateTableResponse()

    def table_drop(self, request, context):
        principal = self.check_auth(context)
        denied = self._acl_denied(principal,
                                  ("ddl", "/" + request.path))
        if denied:
            return pb.DropTableResponse(error=denied)
        sqlast = self._ddl_ast()
        try:
            with self.lock:
                self.cluster.drop_table(sqlast.DropTable(
                    table=request.path))
        except Exception as e:  # noqa: BLE001
            return pb.DropTableResponse(error=str(e))
        return pb.DropTableResponse()

    def table_alter(self, request, context):
        principal = self.check_auth(context)
        denied = self._acl_denied(principal,
                                  ("ddl", "/" + request.path))
        if denied:
            return pb.AlterTableResponse(error=denied)
        sqlast = self._ddl_ast()
        stmt = sqlast.AlterTable(
            table=request.path,
            add_columns=tuple((c.name, c.type)
                              for c in request.add_columns))
        try:
            with self.lock:
                self.cluster.alter_table(stmt)
                desc = self.cluster.scheme.describe(request.path)
        except Exception as e:  # noqa: BLE001
            return pb.AlterTableResponse(error=str(e))
        return pb.AlterTableResponse(
            schema_version=desc.schema_version if desc else 0)

    def table_copy(self, request, context):
        """CopyTable: clone schema, stream every row through the
        normal insert path (schemeshard copy-table analog; the
        miniature copies data rather than sharing parts)."""
        principal = self.check_auth(context)
        denied = self._acl_denied(principal,
                                  ("read", "/" + request.src),
                                  ("ddl", "/" + request.dst))
        if denied:
            return pb.CopyTableResponse(error=denied)
        sqlast = self._ddl_ast()

        with self.lock:
            desc = self.cluster.scheme.describe(request.src)
            if desc is None:
                return pb.CopyTableResponse(
                    error=f"{request.src} is not a table")
            stmt = sqlast.CreateTable(
                table=request.dst,
                columns=tuple((f.name, _sql_type(f.type),
                               not f.nullable)
                              for f in desc.schema.fields),
                primary_key=tuple(desc.primary_key),
                options=(("store", desc.store),
                         ("shards", str(desc.n_shards))))
            try:
                self.cluster.create_table(stmt)
                session = self._acl_session(principal)
                out = session.execute(
                    f"SELECT * FROM {request.src}")
                rows = out.num_rows
                if rows:
                    cols, val = _oracle_to_insert(
                        out, self.cluster.tables[request.src].schema)
                    self.cluster.tables[request.dst].insert(cols, val)
                    self.cluster._invalidate_plans()
            except Exception as e:  # noqa: BLE001
                return pb.CopyTableResponse(error=str(e))
        return pb.CopyTableResponse(rows=rows)

    def table_execute(self, request, context):
        """ExecuteDataQuery with client-driven TxControl: begin opens
        an interactive tx (BEGIN), commit closes it (COMMIT), tx_id
        continues one across calls — the session actor's tx state
        machine (kqp_session_actor.cpp) driven from the wire."""
        principal = self.check_auth(context)
        session = self._owned_session(request.session_id, principal,
                                      context)
        if session is None:
            return pb.ExecuteDataQueryResponse(
                error=f"unknown session {request.session_id}")
        tx = request.tx
        resp = pb.ExecuteDataQueryResponse()
        with self.lock:
            # validate the control block BEFORE touching session
            # state (and inside the lock, so a concurrent call on the
            # same session cannot slip past): a bad tx_id / double
            # begin ran no statement, so it must not disturb an
            # unrelated in-flight transaction
            open_id = getattr(session, "_api_tx_id", None)
            if open_id is not None and \
                    getattr(session, "_tx", None) is None:
                # the tx was closed out-of-band (SQL COMMIT/ROLLBACK
                # through another service on this shared session)
                session._api_tx_id = open_id = None
            if tx.tx_id and tx.tx_id != open_id:
                return pb.ExecuteDataQueryResponse(
                    error=f"unknown tx {tx.tx_id} in this session")
            if tx.begin and open_id is not None:
                return pb.ExecuteDataQueryResponse(
                    error="session already has an open tx")
            try:
                if tx.begin and not tx.commit:
                    # begin+commit together = single-shot autocommit
                    # (the session's default), so only a bare begin
                    # opens interactive state
                    session.execute("BEGIN")
                    self._tx_seq = getattr(self, "_tx_seq", 0) + 1
                    session._api_tx_id = f"tx-{self._tx_seq}"
                out = session.execute(request.sql)
                if tx.commit and getattr(session, "_api_tx_id",
                                         None):
                    res = session.execute("COMMIT")
                    session._api_tx_id = None
                    if isinstance(res, TxResult):
                        resp.tx_step = res.step
                        resp.committed = res.committed
                        if not res.committed:
                            resp.error = res.error or \
                                "not committed"
                            return resp
                elif getattr(session, "_api_tx_id", None):
                    resp.tx_id = session._api_tx_id
            except Exception as e:  # noqa: BLE001
                # a failed statement aborts the interactive tx,
                # matching the reference's session-actor semantics
                if getattr(session, "_api_tx_id", None):
                    session._tx_release()
                    session._api_tx_id = None
                return pb.ExecuteDataQueryResponse(error=str(e))
        if isinstance(out, OracleTable):
            resp.arrow_ipc = oracle_to_ipc(out)
        elif isinstance(out, TxResult):
            resp.tx_step = out.step
            resp.committed = out.committed
            if not out.committed:
                resp.error = out.error or "not committed"
        return resp

    def table_bulk_upsert(self, request, context):
        """BulkUpsert: Arrow IPC payload straight into the shards,
        bypassing SQL compilation (rpc_load_rows.cpp analog — the
        reference's Arrow-format bulk path made primary)."""
        principal = self.check_auth(context)
        denied = self._acl_denied(principal,
                                  ("write", "/" + request.table))
        if denied:
            return pb.BulkUpsertResponse(error=denied)
        from ydb_tpu_torch.api.arrow_io import ipc_to_table

        with self.lock:
            t = self.cluster.tables.get(request.table)
            if t is None:
                return pb.BulkUpsertResponse(
                    error=f"unknown table {request.table}")
            try:
                at = ipc_to_table(request.arrow_ipc)
                cols, val = _arrow_to_insert(at, t.schema)
                res = t.insert(cols, val)
                self.cluster._invalidate_plans()
            except Exception as e:  # noqa: BLE001
                return pb.BulkUpsertResponse(error=str(e))
        return pb.BulkUpsertResponse(rows=at.num_rows, tx_step=res.step)

    def table_read_stream(self, request, context):
        """Server-streaming ReadTable: one consistent snapshot scan,
        batched as Arrow IPC frames (rpc_read_table.cpp analog)."""
        principal = self.check_auth(context)
        batch_rows = request.batch_rows or 65536
        with self.lock:
            session = self._acl_session(principal)
            cols = ", ".join(request.columns) if request.columns \
                else "*"
            try:
                out = session.execute(
                    f"SELECT {cols} FROM {request.path}")
            except Exception as e:  # noqa: BLE001
                yield pb.ReadTableBatch(error=str(e))
                return
            # zero-copy slice views under the lock; serialization and
            # flow control happen OUTSIDE it (result buffers are
            # private to this query, so no torn reads)
            slices = []
            for lo in range(0, out.num_rows, batch_rows) or [0]:
                sl = OracleTable(
                    {k: (np.asarray(v[0])[lo:lo + batch_rows],
                         np.asarray(v[1])[lo:lo + batch_rows])
                     for k, v in out.cols.items()}, out.schema)
                sl.dicts = out.dicts
                slices.append(sl)
        for sl in slices:
            yield pb.ReadTableBatch(arrow_ipc=oracle_to_ipc(sl))

    def table_explain(self, request, context):
        principal = self.check_auth(context)
        with self.lock:
            session = self._acl_session(principal)
            try:
                plan = session.execute(f"EXPLAIN {request.sql}")
            except Exception as e:  # noqa: BLE001
                return pb.ExplainQueryResponse(error=str(e))
        return pb.ExplainQueryResponse(plan_text=plan or "")


def _split_script(script: str) -> list[str]:
    """';'-split OUTSIDE single-quoted literals ('' escapes stay
    inside, matching the SQL tokenizer)."""
    out, buf, in_str = [], [], False
    i = 0
    while i < len(script):
        ch = script[i]
        if in_str:
            if ch == "'":
                if i + 1 < len(script) and script[i + 1] == "'":
                    buf.append("''")
                    i += 2
                    continue
                in_str = False
            buf.append(ch)
        elif ch == "'":
            in_str = True
            buf.append(ch)
        elif ch == ";":
            stmt = "".join(buf).strip()
            if stmt:
                out.append(stmt)
            buf = []
        else:
            buf.append(ch)
        i += 1
    stmt = "".join(buf).strip()
    if stmt:
        out.append(stmt)
    return out


def _sql_type(t) -> str:
    """Type -> DDL spelling that _parse_type round-trips (type_to_str's
    'decimal(scale)' is the schema-JSON spelling, not valid DDL)."""
    if t.is_decimal:
        return f"decimal(38,{t.scale})"
    return t.kind.value


def _oracle_to_insert(out: OracleTable, schema):
    """Result set -> (columns, validity) in the shard-insert shape
    (strings back to raw bytes so the target's dictionaries re-encode)."""
    cols, val = {}, {}
    for f in schema.fields:
        ids = np.asarray(out.column(f.name))
        valid = np.asarray(out.validity(f.name), dtype=bool)
        if f.type.is_string:
            d = out.dicts[f.name] if (out.dicts and f.name in
                                      out.dicts) else None
            if d is None or len(d) == 0:
                cols[f.name] = [b""] * len(ids)
            else:
                cols[f.name] = d.decode(
                    np.clip(ids, 0, len(d) - 1))
        else:
            cols[f.name] = np.asarray(ids, dtype=f.type.physical)
        val[f.name] = valid
    return cols, val


def _arrow_to_insert(at, schema):
    """Arrow IPC payload -> (columns, validity) in the shard-insert
    shape; column set must cover the schema (BulkUpsert writes whole
    rows, as the reference's does). Strings stay raw (the target
    table's own dictionaries re-encode on insert); every other type
    converts through the one shared rule set in blocks.arrow_bridge."""
    from ydb_tpu_torch.blocks.arrow_bridge import _column_to_numpy
    from ydb_tpu_torch.blocks.dictionary import DictionarySet

    names = set(at.column_names)
    missing = [f.name for f in schema.fields if f.name not in names]
    if missing:
        raise ValueError(f"BulkUpsert must set all columns; "
                         f"missing {missing}")
    cols, val = {}, {}
    for f in schema.fields:
        col = at.column(f.name).combine_chunks()
        if f.type.is_string:
            cols[f.name] = ["" if v is None else v
                            for v in col.to_pylist()]
            val[f.name] = np.asarray(col.is_valid())
        else:
            # dicts arg unused on the non-string path
            cols[f.name], val[f.name] = _column_to_numpy(
                col, f, DictionarySet())
    return cols, val


def _ancestors(path: str) -> list[str]:
    parts = path.split("/")
    return ["/".join(parts[:i]) for i in range(1, len(parts))]


_SERVICES = {
    "ydb_tpu.Query": {
        "CreateSession": ("create_session", pb.CreateSessionRequest,
                          pb.CreateSessionResponse),
        "DeleteSession": ("delete_session", pb.DeleteSessionRequest,
                          pb.DeleteSessionResponse),
        "ExecuteQuery": ("execute_query", pb.ExecuteQueryRequest,
                         pb.ExecuteQueryResponse),
    },
    "ydb_tpu.Scheme": {
        "ListDirectory": ("list_directory", pb.ListDirectoryRequest,
                          pb.ListDirectoryResponse),
        "DescribeTable": ("describe_table", pb.DescribeTableRequest,
                          pb.DescribeTableResponse),
    },
    "ydb_tpu.Topic": {
        "Write": ("topic_write", pb.TopicWriteRequest,
                  pb.TopicWriteResponse),
        "Read": ("topic_read", pb.TopicReadRequest, pb.TopicReadResponse),
        "Commit": ("topic_commit", pb.TopicCommitRequest,
                   pb.TopicCommitResponse),
        "StreamRead": ("topic_stream_read", pb.StreamReadRequest,
                       pb.TopicReadResponse, "unary_stream"),
        "StreamWrite": ("topic_stream_write", pb.StreamWriteItem,
                        pb.StreamWriteAck, "stream_stream"),
    },
    "ydb_tpu.Export": {
        "ExportBackup": ("export_backup", pb.ExportRequest,
                         pb.ExportResponse),
        "ListBackups": ("list_backups", pb.ListBackupsRequest,
                        pb.ListBackupsResponse),
    },
    "ydb_tpu.RateLimiter": {
        "CreateResource": ("create_resource", pb.CreateResourceRequest,
                           pb.CreateResourceResponse),
        "AcquireResource": ("acquire_resource",
                            pb.AcquireResourceRequest,
                            pb.AcquireResourceResponse),
        "DescribeResource": ("describe_resource",
                             pb.DescribeResourceRequest,
                             pb.DescribeResourceResponse),
    },
    "ydb_tpu.Scripting": {
        "ExecuteScript": ("execute_script", pb.ExecuteScriptRequest,
                          pb.ExecuteScriptResponse),
    },
    "ydb_tpu.Operation": {
        "GetOperation": ("get_operation", pb.GetOperationRequest,
                         pb.OperationStatus),
        "ListOperations": ("list_operations", pb.ListOperationsRequest,
                           pb.ListOperationsResponse),
        "CancelOperation": ("cancel_operation",
                            pb.CancelOperationRequest,
                            pb.OperationStatus),
    },
    "ydb_tpu.Monitoring": {
        "HealthCheck": ("health_check", pb.HealthCheckRequest,
                        pb.HealthCheckResponse),
    },
    "ydb_tpu.Coordination": {
        "CreateSession": ("coord_session", pb.CoordSessionRequest,
                          pb.CoordSessionResponse),
        "CreateSemaphore": ("coord_create_semaphore",
                            pb.CoordSemaphoreRequest,
                            pb.CoordSemaphoreResponse),
        "AcquireSemaphore": ("coord_acquire",
                             pb.CoordSemaphoreRequest,
                             pb.CoordSemaphoreResponse),
        "ReleaseSemaphore": ("coord_release",
                             pb.CoordSemaphoreRequest,
                             pb.CoordSemaphoreResponse),
        "DescribeSemaphore": ("coord_describe",
                              pb.CoordSemaphoreRequest,
                              pb.CoordSemaphoreResponse),
        "PingSession": ("coord_ping", pb.CoordSessionRequest,
                        pb.CoordSessionResponse),
        "DeleteSession": ("coord_detach", pb.CoordSessionRequest,
                          pb.CoordSessionResponse),
    },
    "ydb_tpu.Cms": {
        "GetConfig": ("cms_get_config", pb.GetConfigRequest,
                      pb.GetConfigResponse),
        "SetConfig": ("cms_set_config", pb.SetConfigRequest,
                      pb.SetConfigResponse),
    },
    "ydb_tpu.Auth": {
        "WhoAmI": ("who_am_i", pb.WhoAmIRequest, pb.WhoAmIResponse),
    },
    "ydb_tpu.Discovery": {
        "ListEndpoints": ("list_endpoints", pb.ListEndpointsRequest,
                          pb.ListEndpointsResponse),
    },
    "ydb_tpu.FederationDiscovery": {
        "ListFederationDatabases": (
            "list_federation_databases",
            pb.ListFederationDatabasesRequest,
            pb.ListFederationDatabasesResponse),
    },
    "ydb_tpu.Table": {
        "CreateSession": ("create_session", pb.CreateSessionRequest,
                          pb.CreateSessionResponse),
        "DeleteSession": ("delete_session", pb.DeleteSessionRequest,
                          pb.DeleteSessionResponse),
        "CreateTable": ("table_create", pb.CreateTableRequest,
                        pb.CreateTableResponse),
        "DropTable": ("table_drop", pb.DropTableRequest,
                      pb.DropTableResponse),
        "AlterTable": ("table_alter", pb.AlterTableAddColumnsRequest,
                       pb.AlterTableResponse),
        "CopyTable": ("table_copy", pb.CopyTableRequest,
                      pb.CopyTableResponse),
        "DescribeTable": ("describe_table", pb.DescribeTableRequest,
                          pb.DescribeTableResponse),
        "ExecuteDataQuery": ("table_execute",
                             pb.ExecuteDataQueryRequest,
                             pb.ExecuteDataQueryResponse),
        "ExplainDataQuery": ("table_explain", pb.ExplainQueryRequest,
                             pb.ExplainQueryResponse),
        "BulkUpsert": ("table_bulk_upsert", pb.BulkUpsertRequest,
                       pb.BulkUpsertResponse),
        "StreamReadTable": ("table_read_stream", pb.ReadTableRequest,
                            pb.ReadTableBatch, "unary_stream"),
    },
    "ydb_tpu.KeyValue": {
        "CreateVolume": ("kv_create_volume", pb.KvVolumeRequest,
                         pb.KvVolumeResponse),
        "DropVolume": ("kv_drop_volume", pb.KvVolumeRequest,
                       pb.KvVolumeResponse),
        "ExecuteTransaction": ("kv_write", pb.KvWriteRequest,
                               pb.KvWriteResponse),
        "Read": ("kv_read", pb.KvReadRequest, pb.KvReadResponse),
        "ListRange": ("kv_list_range", pb.KvListRangeRequest,
                      pb.KvListRangeResponse),
        "DeleteRange": ("kv_delete_range", pb.KvDeleteRangeRequest,
                        pb.KvDeleteRangeResponse),
        "Rename": ("kv_rename", pb.KvRenameRequest,
                   pb.KvRenameResponse),
    },
    "ydb_tpu.Import": {
        "ImportBackup": ("import_backup", pb.ImportRequest,
                         pb.ImportResponse),
    },
}


def make_server(cluster: Cluster, port: int = 0,
                auth_tokens: set[str] | None = None,
                max_workers: int = 8) -> tuple[grpc.Server, int]:
    """Returns (server, bound_port). port=0 picks a free port."""
    proxy = RequestProxy(cluster, auth_tokens)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    proxy.endpoints = (("127.0.0.1", bound),)

    for service, methods in _SERVICES.items():
        handlers = {}
        for rpc_name, spec in methods.items():
            attr, req_cls, resp_cls = spec[:3]
            kind = spec[3] if len(spec) > 3 else "unary_unary"
            ctor = {
                "unary_unary": grpc.unary_unary_rpc_method_handler,
                "unary_stream": grpc.unary_stream_rpc_method_handler,
                "stream_unary": grpc.stream_unary_rpc_method_handler,
                "stream_stream": grpc.stream_stream_rpc_method_handler,
            }[kind]
            handlers[rpc_name] = ctor(
                getattr(proxy, attr),
                request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString,
            )
        server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(service, handlers),))
    server.request_proxy = proxy
    return server, bound
