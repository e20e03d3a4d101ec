"""SQS-compatible HTTP queue proxy over the topic (PersQueue) plane.

Mirror of the reference's message-queue surface (ydb/core/ymq — the
SQS-compatible queue service — and core/http_proxy routing HTTP
requests into it; SURVEY.md §2.12 row "SQS/HTTP proxy"): an HTTP
listener speaking the AWS SQS JSON protocol (X-Amz-Target:
AmazonSQS.<Action>, POST application/x-amz-json-1.0) so stock SQS
clients and plain HTTP callers can use the framework as a queue.

Queue semantics over topics:
  * a queue is a single-partition topic + a per-queue consumer;
  * ReceiveMessage leases messages for ``VisibilityTimeout`` seconds:
    a message delivered but not deleted reappears after the timeout
    (at-least-once, like SQS standard queues);
  * DeleteMessage acks by receipt handle; the consumer's committed
    offset advances over a prefix of deleted messages, so the durable
    state is the PQ commit plus a small in-flight lease table;
  * ApproximateNumberOfMessages = topic backlog minus committed.

Supported actions: CreateQueue, DeleteQueue, ListQueues, GetQueueUrl,
SendMessage, ReceiveMessage, DeleteMessage, PurgeQueue,
GetQueueAttributes.

The port's own copy of ``ydb_tpu/api/sqs.py`` over the port's topics:
the same queue topics (``sqs/<name>``, one partition, consumer ``sqs``)
and the same JSON bodies.
"""

from __future__ import annotations

import json
import secrets
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ydb_tpu_torch.engine.blobs import BlobStore, MemBlobStore
from ydb_tpu_torch.topic.topic import Topic


class SqsError(Exception):
    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


class _Queue:
    """One SQS queue = one single-partition topic + lease table."""

    def __init__(self, name: str, store: BlobStore, now=time.time,
                 visibility_timeout: float = 30.0):
        self.name = name
        self.topic = Topic(f"sqs/{name}", store, n_partitions=1)
        self.part = self.topic.partitions[0]
        self.now = now
        self.visibility_timeout = visibility_timeout
        # offset -> (receipt_handle, invisible_until)
        self.leases: dict[int, tuple[str, float]] = {}
        self.deleted: set[int] = set()

    def send(self, body: str, attributes: dict | None = None) -> str:
        payload = json.dumps({"body": body,
                              "attributes": attributes or {}})
        offs = self.part.write([{"data": payload}])
        return f"{self.name}-{offs[0]}"

    def _advance_commit(self) -> None:
        """Commit the consumer offset over the deleted prefix."""
        committed = self.part.committed("sqs")
        while committed in self.deleted:
            self.deleted.discard(committed)
            committed += 1
        self.part.commit("sqs", committed)

    def receive(self, max_messages: int = 1,
                visibility_timeout: float | None = None) -> list[dict]:
        now = self.now()
        vis = (visibility_timeout if visibility_timeout is not None
               else self.visibility_timeout)
        out = []
        start = self.part.committed("sqs")
        for msg in self.part.read(start, limit=max(64, max_messages)):
            off = msg["offset"]
            if off in self.deleted:
                continue
            lease = self.leases.get(off)
            if lease is not None and lease[1] > now:
                continue  # still invisible to other consumers
            handle = secrets.token_hex(12)
            self.leases[off] = (handle, now + vis)
            payload = json.loads(msg["data"])
            out.append({
                "MessageId": f"{self.name}-{off}",
                "ReceiptHandle": handle,
                "Body": payload["body"],
                "Attributes": payload["attributes"],
            })
            if len(out) >= max_messages:
                break
        return out

    def delete(self, receipt_handle: str) -> None:
        for off, (handle, _until) in list(self.leases.items()):
            if handle == receipt_handle:
                del self.leases[off]
                self.deleted.add(off)
                self._advance_commit()
                return
        raise SqsError("ReceiptHandleIsInvalid",
                       f"no in-flight message for {receipt_handle!r}")

    def purge(self) -> None:
        self.leases.clear()
        self.deleted.clear()
        self.part.commit("sqs", self.part.head_offset)

    def attributes(self) -> dict:
        backlog = self.part.head_offset - self.part.committed("sqs")
        in_flight = sum(1 for _off, (_h, until) in self.leases.items()
                        if until > self.now())
        return {
            "ApproximateNumberOfMessages":
                str(max(0, backlog - len(self.deleted) - in_flight)),
            "ApproximateNumberOfMessagesNotVisible": str(in_flight),
            "VisibilityTimeout": str(int(self.visibility_timeout)),
        }


class SqsService:
    """Action dispatch, shared by the HTTP front and direct callers."""

    def __init__(self, store: BlobStore | None = None, now=time.time,
                 base_url: str = "http://localhost"):
        self.store = store if store is not None else MemBlobStore()
        self.now = now
        self.base_url = base_url
        self.queues: dict[str, _Queue] = {}

    def _queue(self, params: dict) -> _Queue:
        url = params.get("QueueUrl", "")
        name = params.get("QueueName") or url.rsplit("/", 1)[-1]
        q = self.queues.get(name)
        if q is None:
            raise SqsError("QueueDoesNotExist", f"no queue {name!r}")
        return q

    def dispatch(self, action: str, params: dict) -> dict:
        fn = getattr(self, f"_do_{action.lower()}", None)
        if fn is None:
            raise SqsError("InvalidAction", f"unknown action {action}")
        return fn(params)

    def _url(self, name: str) -> str:
        return f"{self.base_url}/queue/{name}"

    def _do_createqueue(self, p: dict) -> dict:
        name = p["QueueName"]
        if name not in self.queues:
            attrs = p.get("Attributes", {})
            vis = float(attrs.get("VisibilityTimeout", 30))
            self.queues[name] = _Queue(name, self.store, now=self.now,
                                       visibility_timeout=vis)
        return {"QueueUrl": self._url(name)}

    def _do_deletequeue(self, p: dict) -> dict:
        self.queues.pop(self._queue(p).name, None)
        return {}

    def _do_listqueues(self, p: dict) -> dict:
        prefix = p.get("QueueNamePrefix", "")
        return {"QueueUrls": [self._url(n) for n in sorted(self.queues)
                              if n.startswith(prefix)]}

    def _do_getqueueurl(self, p: dict) -> dict:
        return {"QueueUrl": self._url(self._queue(p).name)}

    def _do_sendmessage(self, p: dict) -> dict:
        q = self._queue(p)
        mid = q.send(p["MessageBody"],
                     p.get("MessageAttributes"))
        return {"MessageId": mid}

    def _do_receivemessage(self, p: dict) -> dict:
        q = self._queue(p)
        msgs = q.receive(
            max_messages=int(p.get("MaxNumberOfMessages", 1)),
            visibility_timeout=(
                float(p["VisibilityTimeout"])
                if "VisibilityTimeout" in p else None))
        return {"Messages": msgs}

    def _do_deletemessage(self, p: dict) -> dict:
        self._queue(p).delete(p["ReceiptHandle"])
        return {}

    def _do_purgequeue(self, p: dict) -> dict:
        self._queue(p).purge()
        return {}

    def _do_getqueueattributes(self, p: dict) -> dict:
        return {"Attributes": self._queue(p).attributes()}


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_POST(self):  # noqa: N802 - http.server API
        srv: SqsHttpServer = self.server.sqs  # type: ignore[attr-defined]
        target = self.headers.get("X-Amz-Target", "")
        action = target.split(".")[-1] if "." in target else target
        length = int(self.headers.get("Content-Length", 0))
        try:
            params = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            self._reply(400, {"__type": "InvalidRequest",
                              "message": "bad JSON"})
            return
        if not action:
            action = params.pop("Action", "")
        try:
            with srv.lock:
                out = srv.service.dispatch(action, params)
            self._reply(200, out)
        except SqsError as e:
            self._reply(400, {"__type": e.code, "message": str(e)})
        except Exception as e:  # noqa: BLE001 - surface, don't die
            self._reply(500, {"__type": "InternalFailure",
                              "message": repr(e)})

    def _reply(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/x-amz-json-1.0")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class SqsHttpServer:
    """Threaded SQS-wire HTTP listener."""

    def __init__(self, store: BlobStore | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 lock: threading.Lock | None = None, now=time.time):
        self.lock = lock if lock is not None else threading.Lock()
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.sqs = self  # type: ignore[attr-defined]
        self.port = self._server.server_address[1]
        self.service = SqsService(
            store, now=now, base_url=f"http://{host}:{self.port}")
        self._thread: threading.Thread | None = None

    def start(self) -> "SqsHttpServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="sqs")
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
