"""The port's executor pools (``ydb_tpu_torch/runtime/pools.py``)
against the reference's.

The 2 cases of ``tests/test_pools.py`` run once through each package:
the same pongs in the same order, the same per-pool delivery, pools on
distinct threads. Every wait is bounded by a deadline and the pools'
threads are joined with a timeout. Tolerance: none."""

import threading
import time

from ydb_tpu.runtime import actors as ractors
from ydb_tpu.runtime import pools as rpools

from ydb_tpu_torch.runtime import actors
from ydb_tpu_torch.runtime import pools

KITS = {"ref": (ractors, rpools), "port": (actors, pools)}


def kit_actors(am):
    class Collector(am.Actor):
        def __init__(self):
            super().__init__()
            self.got = []
            self.threads = set()

        def receive(self, message, sender):
            self.threads.add(threading.get_ident())
            self.got.append(message)
            if isinstance(message, tuple) and message[0] == "ping":
                self.send(sender, ("pong", message[1]))

    class Pinger(am.Actor):
        def __init__(self, peer, n):
            super().__init__()
            self.peer = peer
            self.n = n
            self.pongs = []

        def on_start(self):
            for i in range(self.n):
                self.send(self.peer, ("ping", i))

        def receive(self, message, sender):
            self.pongs.append(message[1])

    return Collector, Pinger


def both(run):
    outs = [run(*k) for k in KITS.values()]
    assert outs[0] == outs[1]
    return outs[1]


def test_cross_pool_ping_pong_preserves_order():
    def run(am, pm):
        Collector, Pinger = kit_actors(am)
        p = pm.ThreadedPools(n_pools=3)
        col = Collector()
        col_id = p.register(col, pool=2)
        ping = Pinger(col_id, 50)
        ping_id = p.register(ping, pool=0)
        p.start()
        try:
            deadline = time.monotonic() + 15
            while len(ping.pongs) < 50 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert ping.pongs == list(range(50))  # FIFO both directions
            assert [m[1] for m in col.got] == list(range(50))
            p.drain(timeout=10)
            # a pool counts its steps just after it leaves run()
            while (sum(s["delivered"] for s in p.stats()) < 100
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            delivered = [s["delivered"] for s in p.stats()]
            assert delivered == [50, 0, 50]
            return (ping.pongs, col.got, delivered,
                    (col_id.node, ping_id.node))
        finally:
            p.stop()
            assert not any(t.is_alive() for t in p._threads)

    assert both(run)[3] == (3, 1)


def test_pools_run_on_distinct_threads():
    def run(am, pm):
        Collector, _ = kit_actors(am)
        p = pm.ThreadedPools(n_pools=2)
        a, b = Collector(), Collector()
        ida = p.register(a, pool=0)
        idb = p.register(b, pool=1)
        p.start()
        try:
            for i in range(20):
                p.send(ida, i)
                p.send(idb, i)
            p.drain(timeout=10)
            assert len(a.got) == len(b.got) == 20
            assert a.threads and b.threads and a.threads != b.threads
            stats = p.stats()
            assert sum(s["delivered"] for s in stats) >= 40
            assert [s["queued"] for s in stats] == [0, 0]
            return a.got, b.got, [s["pool"] for s in stats]
        finally:
            p.stop()
            assert not any(t.is_alive() for t in p._threads)

    both(run)
