"""The port's kernel bench (``ydb_tpu_torch/obs/kernelbench.py``) on the
CPU: the tier-1 wiring of the reference's (``tests/test_staging.py``):
``--smoke --json --device cpu`` runs every bench but ``--shuffle`` at
tiny sizes, each of them checked (group-by against the CPU oracle,
rtol 1e-9; the A/B benches bit-identical across their two sides; the
overhead benches within the smoke's 50% no-catastrophe bound, zero
timeline events while it is off, zero leaked handles, zero unbudgeted
allocations). Besides: the group-by bench past 512 groups on both
lowerings (the path of the two CUDA kernels, here their plain
versions), and ``--shuffle`` raising the typed error that names the
mesh's ROADMAP item.

The overhead verdicts compare host times of two sides run in turns. The
benches run on one intra-op thread here: with the default pool (one
thread per core) in each of several test processes sharing the cores,
the two sides would time thread-pool contention instead of their own
work."""

import json

import pytest
import torch

from ydb_tpu_torch.obs import kernelbench
from ydb_tpu_torch.workload import tpch


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_smoke_json_on_the_cpu(capsys):
    assert kernelbench.main(["--smoke", "--json", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["device"] == "cpu"
    assert report["group_by"]["oracle_check"] == "ok"
    for name in ("pruning", "resident", "streaming", "fusion",
                 "batching"):
        assert report[name]["identical"] is True, name
    for name in ("profile_overhead", "chaos_overhead", "leaksan_overhead",
                 "admission_overhead", "memsan_overhead"):
        assert report[name]["within_budget"] is True, name
    assert report["profile_overhead"]["timeline_disabled_events"] == 0
    assert report["memsan_overhead"]["warm_unbudgeted"] == 0
    assert report["leaksan_overhead"]["drained"] is True
    assert report["pruning"]["chunks_skipped"] > 0
    assert report["shuffle"]["identical"] is True
    assert "skew" not in report["shuffle"]


def test_group_by_past_512_groups_both_lowerings():
    out = kernelbench.bench_group_by(20_000, 1_745, 2, 1, device="cpu")
    assert out["oracle_check"] == "ok"
    assert out["fused_rows_per_sec"] > 0 and out["peragg_rows_per_sec"] > 0


def test_shuffle_names_the_mesh_item(capsys):
    """``--shuffle`` runs the A/B over the port's shard mesh (it raised
    until the mesh was ported): the skew case included, every side
    lossless and colocated."""
    assert kernelbench.main(["--shuffle", "--device", "cpu", "--json",
                             "--rows", "5000", "--groups", "7",
                             "--iters", "1", "--shuffle-rows", "8192"]) == 0
    sh = json.loads(capsys.readouterr().out)["shuffle"]
    assert sh["identical"] and sh["capacity_ratio"] >= 4
    assert sh["skew"]["grows"] >= 1 and sh["skew"]["identical"]


def test_profile_verdict_counts_and_times_the_trace_work():
    shard = kernelbench.lineitem_shard("t", 0.005, 1 << 12, "cpu",
                                       tpch.TpchData(sf=0.005, seed=5))
    out = kernelbench.bench_profile_overhead(0.005, 2, 1 << 12,
                                             assert_within=0.5,
                                             device="cpu", shard=shard)
    # the profiled scan's spans: shard.scan and its prefetch producer,
    # which the conveyor carried onto a worker under the trace
    assert out["trace_spans"] >= 2 and out["trace_wraps"] >= 1, out
    assert out["profile_added_ms"] > 0, out
    assert out["rows"] == shard[1] and out["rounds"] == 2
    assert out["timeline_disabled_events"] == 0
    # the ring's verdict counts and times its own work: the records and
    # byte counters of one ring-on scan, and its one end-of-scan sync
    assert out["timeline_ring_events"] >= 2, out
    assert out["timeline_byte_adds"] >= 1 and out["timeline_syncs"] == 1
    assert out["timeline_added_ms"] == pytest.approx(
        out["timeline_ring_ms"] + out["timeline_sync_ms"], abs=2e-4)
    assert "timeline_wall_ab_pct" in out and out["timeline_within_budget"]
