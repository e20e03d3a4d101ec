"""Command-line interface: `python -m ydb_tpu_torch.cli <command>`.

Mirror of the reference's `ydb` tool (apps/ydb, public/lib/ydb_cli;
SURVEY.md layer 9): server mode, interactive SQL, scheme browsing,
topic read/write, and workload benchmark runners.

Commands:
  serve     --data-dir D [--port P] [--auth-token T]   run a node
            [--pg-port P] [--kafka-port P]             wire-compat fronts
  sql       -e ENDPOINT "SELECT ..."                   run a query
  scheme ls -e ENDPOINT [PATH]                         list a directory
  scheme describe -e ENDPOINT PATH                     table metadata
  topic write|read -e ENDPOINT ...                     topic I/O
  workload tpch --sf 0.01 [--queries q1,q6]            embedded bench
            clickbench | tpcds | load

The port's own copy of ``ydb_tpu/cli.py``, with the same verbs and
options, over the port's ``Cluster``, fronts and workload runners.
``--platform``, which picks the reference's XLA platform, names the
port's device: ``cuda`` by default, ``cpu`` only when asked; nothing
falls back.
"""

from __future__ import annotations

import argparse
import sys
import time


def _connect(args):
    from ydb_tpu_torch.api.client import Driver

    return Driver(args.endpoint, auth_token=args.auth_token)


def cmd_serve(args):
    from ydb_tpu_torch.api.server import make_server
    from ydb_tpu_torch.config import AppConfig
    from ydb_tpu_torch.engine.blobs import DirBlobStore, MemBlobStore
    from ydb_tpu_torch.kqp.session import Cluster

    config = AppConfig()
    if args.yaml_config:
        with open(args.yaml_config) as f:
            config = AppConfig.from_yaml(f.read())
    data_dir = args.data_dir or config.data_dir
    port = args.port if args.port is not None else config.grpc_port
    store = DirBlobStore(data_dir) if data_dir else MemBlobStore()
    cluster = Cluster(store=store, config=config, device=args.platform)
    tokens = set(config.auth_tokens) or None
    if args.auth_token:
        tokens = (tokens or set()) | {args.auth_token}
    server, port = make_server(cluster, port=port, auth_tokens=tokens)
    server.start()
    extra_fronts = []
    if args.pg_port is not None:
        from ydb_tpu_torch.api.pgwire import PgWireServer

        pg = PgWireServer(cluster, port=args.pg_port,
                          auth_tokens=tokens,
                          lock=server.request_proxy.lock).start()
        extra_fronts.append(pg)
        print(f"pgwire listening on 127.0.0.1:{pg.port}", flush=True)
    if args.kafka_port is not None:
        from ydb_tpu_torch.api.kafka import KafkaServer

        kf = KafkaServer(cluster, port=args.kafka_port,
                         auth_tokens=tokens,
                         lock=server.request_proxy.lock).start()
        extra_fronts.append(kf)
        print(f"kafka listening on 127.0.0.1:{kf.port}", flush=True)
    if args.mon_port is not None:
        from ydb_tpu_torch.obs.viewer import Viewer

        mon = Viewer(cluster, port=args.mon_port, auth_tokens=tokens,
                     lock=server.request_proxy.lock).start()
        extra_fronts.append(mon)
        print(f"monitoring on http://127.0.0.1:{mon.port}", flush=True)
    if args.sqs_port is not None:
        from ydb_tpu_torch.api.sqs import SqsHttpServer

        sqs = SqsHttpServer(cluster.store, port=args.sqs_port,
                            lock=server.request_proxy.lock).start()
        extra_fronts.append(sqs)
        print(f"sqs on http://127.0.0.1:{sqs.port}", flush=True)
    print(f"ydb_tpu_torch serving on 127.0.0.1:{port}", flush=True)
    period = (args.background_period
              if args.background_period is not None
              else config.background_period_seconds)
    try:
        while True:
            time.sleep(period)
            # cluster state is single-writer: background maintenance
            # takes the same lock the RPC handlers serialize on
            with server.request_proxy.lock:
                cluster.run_background()
    except KeyboardInterrupt:
        for front in extra_fronts:
            front.stop()
        server.stop(1)


def cmd_sql(args):
    driver = _connect(args)
    q = driver.query_client()
    t0 = time.monotonic()
    out = q.execute(args.query)
    dt = time.monotonic() - t0
    import pyarrow as pa

    if isinstance(out, str):  # EXPLAIN: the rendered plan
        print(out)
    elif isinstance(out, pa.Table):
        print(out.to_pandas().to_string(index=False))
        print(f"-- {out.num_rows} rows in {dt:.3f}s", file=sys.stderr)
    else:
        step, committed = out
        print(f"-- {'committed' if committed else 'FAILED'} at step "
              f"{step} in {dt:.3f}s", file=sys.stderr)
    driver.close()


def cmd_scheme(args):
    driver = _connect(args)
    sc = driver.scheme_client()
    if args.scheme_cmd == "ls":
        for path, kind in sc.list_directory(args.path):
            print(f"{kind:8} {path}")
    else:
        d = sc.describe_table(args.path)
        print(f"table {d.path}  store={d.store}  shards={d.shards}  "
              f"version={d.schema_version}")
        for c in d.columns:
            null = "" if c.nullable else " NOT NULL"
            pk = " (pk)" if c.name in d.primary_key else ""
            print(f"  {c.name:24} {c.type}{null}{pk}")
    driver.close()


def cmd_topic(args):
    driver = _connect(args)
    tc = driver.topic_client()
    if args.topic_cmd == "write":
        p, off = tc.write(args.topic, args.data, key=args.key or "")
        print(f"partition {p} offset {off}")
    else:
        msgs = tc.read(args.topic, args.consumer, args.limit)
        for p, off, data in msgs:
            print(f"[{p}:{off}] {data.decode(errors='replace')}")
        if msgs and args.commit:
            tops = {}
            for p, off, _ in msgs:
                tops[p] = max(tops.get(p, -1), off)
            for p, off in tops.items():
                tc.commit(args.topic, args.consumer, p, off)
    driver.close()


def _run_workload(args, run, **kwargs):
    queries = args.queries.split(",") if args.queries else None
    results = run(queries=queries, iterations=args.iterations,
                  device=args.platform, **kwargs)
    for name, seconds, rows in results:
        print(f"{name:6} {seconds * 1000:9.1f} ms   {rows} rows")


def cmd_workload(args):
    from ydb_tpu_torch.workload.runner import run_tpch

    _run_workload(args, run_tpch, sf=args.sf)


def cmd_clickbench(args):
    from ydb_tpu_torch.workload.clickbench import run_clickbench

    _run_workload(args, run_clickbench, rows=args.rows,
                  verify=not args.no_verify)


def cmd_tpcds(args):
    from ydb_tpu_torch.workload.tpcds import run_tpcds

    _run_workload(args, run_tpcds, sf=args.sf,
                  verify=not args.no_verify)


def cmd_loadtest(args):
    from ydb_tpu_torch.kqp.session import Cluster
    from ydb_tpu_torch.obs.loadtest import LoadService

    svc = LoadService(Cluster(device=args.platform))
    r = svc.run(args.kind, requests=args.requests)
    print(f"{r['kind']:12} {r['requests']} reqs  {r['errors']} errors  "
          f"{r['rps']} rps  p50={r['p50_ms']}ms p99={r['p99_ms']}ms")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ydb_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_conn(p):
        p.add_argument("-e", "--endpoint", default="127.0.0.1:2136")
        p.add_argument("--auth-token", default=None)

    p = sub.add_parser("serve")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--auth-token", default=None)
    p.add_argument("--platform", default="cuda",
                   help="device the node runs on (cuda, or cpu)")
    p.add_argument("--background-period", type=float, default=None)
    p.add_argument("--yaml-config", default=None)
    p.add_argument("--pg-port", type=int, default=None,
                   help="also listen for PostgreSQL clients (0=auto)")
    p.add_argument("--kafka-port", type=int, default=None,
                   help="also listen for Kafka clients (0=auto)")
    p.add_argument("--mon-port", type=int, default=None,
                   help="monitoring HTTP endpoint (0=auto)")
    p.add_argument("--sqs-port", type=int, default=None,
                   help="SQS-compatible queue HTTP endpoint (0=auto)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("sql")
    add_conn(p)
    p.add_argument("query")
    p.set_defaults(fn=cmd_sql)

    p = sub.add_parser("scheme")
    ssub = p.add_subparsers(dest="scheme_cmd", required=True)
    pls = ssub.add_parser("ls")
    add_conn(pls)
    pls.add_argument("path", nargs="?", default="/")
    pls.set_defaults(fn=cmd_scheme)
    pd = ssub.add_parser("describe")
    add_conn(pd)
    pd.add_argument("path")
    pd.set_defaults(fn=cmd_scheme)

    p = sub.add_parser("topic")
    tsub = p.add_subparsers(dest="topic_cmd", required=True)
    tw = tsub.add_parser("write")
    add_conn(tw)
    tw.add_argument("topic")
    tw.add_argument("data")
    tw.add_argument("--key", default=None)
    tw.set_defaults(fn=cmd_topic)
    tr = tsub.add_parser("read")
    add_conn(tr)
    tr.add_argument("topic")
    tr.add_argument("--consumer", default="cli")
    tr.add_argument("--limit", type=int, default=20)
    tr.add_argument("--commit", action="store_true")
    tr.set_defaults(fn=cmd_topic)

    p = sub.add_parser("workload")
    wsub = p.add_subparsers(dest="workload_cmd", required=True)
    wt = wsub.add_parser("tpch")
    wt.add_argument("--sf", type=float, default=0.01)
    wt.add_argument("--queries", default=None)
    wt.add_argument("--iterations", type=int, default=1)
    wt.add_argument("--platform", default="cuda")
    wt.set_defaults(fn=cmd_workload)
    wc = wsub.add_parser("clickbench")
    wc.add_argument("--rows", type=int, default=100_000)
    wc.add_argument("--queries", default=None)
    wc.add_argument("--iterations", type=int, default=1)
    wc.add_argument("--platform", default="cuda")
    wc.add_argument("--no-verify", action="store_true")
    wc.set_defaults(fn=cmd_clickbench)
    wd = wsub.add_parser("tpcds")
    wd.add_argument("--sf", type=float, default=0.002)
    wd.add_argument("--queries", default=None)
    wd.add_argument("--iterations", type=int, default=1)
    wd.add_argument("--platform", default="cuda")
    wd.add_argument("--no-verify", action="store_true")
    wd.set_defaults(fn=cmd_tpcds)
    wl = wsub.add_parser("load")
    wl.add_argument("--kind", default="kv_upsert",
                    choices=["kv_upsert", "select", "storage_put"])
    wl.add_argument("--requests", type=int, default=100)
    wl.add_argument("--platform", default="cuda")
    wl.set_defaults(fn=cmd_loadtest)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
