"""The port's SQS front (``ydb_tpu_torch/api/sqs.py``) against the
reference's.

Each of the 6 cases of ``tests/test_sqs.py`` runs through both packages
(HTTP cases against each package's ``SqsHttpServer``, the others against
its ``SqsService`` on a manual clock): the same bodies, errors and
committed offsets. Added: one call sequence (queue lifecycle, sends,
receives with leases, out-of-order deletes, a lapsed lease redelivered,
a stale handle refused, attributes, purge, delete) through both
services, every JSON body equal once the random receipt handles are
masked. Tolerance: none."""

import json
import urllib.error
import urllib.request

import pytest

from ydb_tpu.api import sqs as rsqs
from ydb_tpu.engine.blobs import MemBlobStore as RMemBlobStore

from ydb_tpu_torch.api import sqs
from ydb_tpu_torch.engine.blobs import MemBlobStore

from conftest import Clock

#: (sqs module, MemBlobStore) of each package
KITS = ((rsqs, RMemBlobStore), (sqs, MemBlobStore))


def call(port, action, params):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=json.dumps(params).encode(),
        headers={"X-Amz-Target": f"AmazonSQS.{action}",
                 "Content-Type": "application/x-amz-json-1.0"},
        method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _both(case):
    out = [case(*kit) for kit in KITS]
    assert out[0] == out[1]
    return out[1]


def _served(mod, mem, fn):
    srv = mod.SqsHttpServer(mem()).start()
    try:
        return fn(srv.port)
    finally:
        srv.stop()


def test_http_queue_lifecycle():
    def case(mod, mem):
        def run(p):
            url = call(p, "CreateQueue", {"QueueName": "jobs"})["QueueUrl"]
            out = [url.replace(str(p), "P"),
                   [u.replace(str(p), "P") for u in
                    call(p, "ListQueues", {})["QueueUrls"]],
                   call(p, "GetQueueUrl", {"QueueName": "jobs"})[
                       "QueueUrl"] == url,
                   call(p, "SendMessage", {"QueueUrl": url,
                                           "MessageBody": "work #1"})]
            msgs = call(p, "ReceiveMessage", {"QueueUrl": url})["Messages"]
            out.append([(m["MessageId"], m["Body"]) for m in msgs])
            out.append(call(p, "DeleteMessage", {
                "QueueUrl": url, "ReceiptHandle": msgs[0]["ReceiptHandle"]}))
            out.append(call(p, "ReceiveMessage", {"QueueUrl": url}))
            out.append(call(p, "GetQueueAttributes", {"QueueUrl": url}))
            return out
        return _served(mod, mem, run)

    out = _both(case)
    assert out[0].endswith("/queue/jobs") and out[1] == [out[0]] and out[2]
    assert out[3]["MessageId"].startswith("jobs-")
    assert out[4] == [("jobs-0", "work #1")] and out[6]["Messages"] == []
    assert out[7]["Attributes"]["ApproximateNumberOfMessages"] == "0"


def test_http_error_shapes():
    def case(mod, mem):
        def run(p):
            req = urllib.request.Request(
                f"http://127.0.0.1:{p}/",
                data=json.dumps({"QueueUrl": "x/nope"}).encode(),
                headers={"X-Amz-Target": "AmazonSQS.SendMessage"},
                method="POST")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=10)
            return ei.value.code, json.loads(ei.value.read())
        return _served(mod, mem, run)

    code, body = _both(case)
    assert code == 400 and body["__type"] == "QueueDoesNotExist"


def test_visibility_timeout_redelivery():
    def case(mod, mem):
        clock = Clock(1000.0)
        svc = mod.SqsService(mem(), now=clock)
        svc.dispatch("CreateQueue", {
            "QueueName": "q", "Attributes": {"VisibilityTimeout": 10}})
        svc.dispatch("SendMessage", {"QueueName": "q", "MessageBody": "m1"})
        got = svc.dispatch("ReceiveMessage", {"QueueName": "q"})["Messages"]
        hidden = svc.dispatch("ReceiveMessage", {"QueueName": "q"})
        clock.t += 15
        again = svc.dispatch("ReceiveMessage",
                             {"QueueName": "q"})["Messages"]
        with pytest.raises(mod.SqsError) as ei:
            svc.dispatch("DeleteMessage", {
                "QueueName": "q", "ReceiptHandle": got[0]["ReceiptHandle"]})
        fresh = again[0]["ReceiptHandle"] != got[0]["ReceiptHandle"]
        svc.dispatch("DeleteMessage", {
            "QueueName": "q", "ReceiptHandle": again[0]["ReceiptHandle"]})
        attrs = svc.dispatch("GetQueueAttributes", {"QueueName": "q"})
        return (len(got), hidden, [m["Body"] for m in again], fresh,
                ei.value.code, attrs)

    n, hidden, again, fresh, code, attrs = _both(case)
    assert n == 1 and hidden == {"Messages": []} and again == ["m1"]
    assert fresh and code == "ReceiptHandleIsInvalid"
    assert attrs["Attributes"]["ApproximateNumberOfMessages"] == "0"


def test_out_of_order_delete_advances_commit_over_prefix():
    def case(mod, mem):
        svc = mod.SqsService(mem())
        svc.dispatch("CreateQueue", {"QueueName": "q"})
        for i in range(3):
            svc.dispatch("SendMessage", {"QueueName": "q",
                                         "MessageBody": f"m{i}"})
        msgs = svc.dispatch("ReceiveMessage", {
            "QueueName": "q", "MaxNumberOfMessages": 3})["Messages"]
        q = svc.queues["q"]
        commits = []
        for i in (1, 0, 2):
            svc.dispatch("DeleteMessage", {
                "QueueName": "q", "ReceiptHandle": msgs[i]["ReceiptHandle"]})
            commits.append(q.part.committed("sqs"))
        return [m["Body"] for m in msgs], commits

    assert _both(case) == (["m0", "m1", "m2"], [0, 2, 3])


def test_queue_backlog_survives_reboot():
    def case(mod, mem):
        store = mem()
        svc = mod.SqsService(store)
        svc.dispatch("CreateQueue", {"QueueName": "q"})
        svc.dispatch("SendMessage", {"QueueName": "q", "MessageBody": "x"})
        svc2 = mod.SqsService(store)
        svc2.dispatch("CreateQueue", {"QueueName": "q"})
        msgs = svc2.dispatch("ReceiveMessage", {"QueueName": "q"})
        return [m["Body"] for m in msgs["Messages"]]

    assert _both(case) == ["x"]


def test_purge_and_max_messages():
    def case(mod, mem):
        svc = mod.SqsService(mem())
        svc.dispatch("CreateQueue", {"QueueName": "q"})
        for i in range(5):
            svc.dispatch("SendMessage", {"QueueName": "q",
                                         "MessageBody": str(i)})
        two = svc.dispatch("ReceiveMessage", {
            "QueueName": "q", "MaxNumberOfMessages": 2})["Messages"]
        svc.dispatch("PurgeQueue", {"QueueName": "q"})
        return ([m["Body"] for m in two],
                svc.dispatch("ReceiveMessage", {"QueueName": "q"}))

    assert _both(case) == (["0", "1"], {"Messages": []})


def test_call_sequence_same_bodies():
    def case(mod, mem):
        clock = Clock(50.0)
        store = mem()
        svc = mod.SqsService(store, now=clock, base_url="http://h")
        handles: dict[str, str] = {}
        bodies = []

        def do(action, **params):
            try:
                out = svc.dispatch(action, params)
            except mod.SqsError as e:
                out = {"error": e.code}
            for m in out.get("Messages", ()):
                h = m["ReceiptHandle"]
                handles.setdefault(h, f"h{len(handles)}")
                m["ReceiptHandle"] = handles[h]
            bodies.append(json.loads(json.dumps(out)))
            return out

        def real(alias):
            return next(h for h, a in handles.items() if a == alias)

        do("CreateQueue", QueueName="jobs",
           Attributes={"VisibilityTimeout": 5})
        do("CreateQueue", QueueName="other")
        do("ListQueues")
        do("ListQueues", QueueNamePrefix="jo")
        for i in range(6):
            do("SendMessage", QueueUrl="http://h/queue/jobs",
               MessageBody=f"job {i}", MessageAttributes={"n": str(i)})
        first = do("ReceiveMessage", QueueName="jobs",
                   MaxNumberOfMessages=3)["Messages"]
        do("GetQueueAttributes", QueueName="jobs")
        do("DeleteMessage", QueueName="jobs",
           ReceiptHandle=real(first[2]["ReceiptHandle"]))
        do("DeleteMessage", QueueName="jobs",
           ReceiptHandle=real(first[0]["ReceiptHandle"]))
        do("ReceiveMessage", QueueName="jobs", MaxNumberOfMessages=10,
           VisibilityTimeout=2)
        clock.t += 6
        again = do("ReceiveMessage", QueueName="jobs",
                   MaxNumberOfMessages=10)["Messages"]
        do("DeleteMessage", QueueName="jobs",
           ReceiptHandle=real(first[1]["ReceiptHandle"]))
        for m in again:
            do("DeleteMessage", QueueName="jobs",
               ReceiptHandle=real(m["ReceiptHandle"]))
        do("GetQueueAttributes", QueueName="jobs")
        do("SendMessage", QueueName="jobs", MessageBody="late")
        do("PurgeQueue", QueueName="jobs")
        do("GetQueueAttributes", QueueName="jobs")
        do("NoSuchAction")
        do("DeleteQueue", QueueName="other")
        do("GetQueueUrl", QueueName="other")
        return bodies, store.list("tablet/pq/")

    bodies, blobs = _both(case)
    assert len(bodies) == 28 and blobs
    assert bodies[-3:] == [{"error": "InvalidAction"}, {},
                           {"error": "QueueDoesNotExist"}]
