"""Two repairs of the port, on the CPU (and one case on the card).

* ``kernels.fused_group_reduce`` at 512 groups or fewer over a block of
  at least 2^29 rows: the reference contracts integers in integer dtype
  there (``ydb_tpu/ssa/kernels.py:299-302``); CUDA has no integer
  matmul, so the port takes the exact int 2-D scatter-add. With the row
  bound patched down, that path must equal the one-hot result bit for
  bit, on the CPU and on the card.
* ``YDB_TPU_TORCH_DQ_TASKS`` / ``YDB_TPU_TORCH_DQ_BLOCK_ROWS``, the
  reference's ``YDB_TPU_DQ_TASKS`` / ``YDB_TPU_DQ_BLOCK_ROWS``, reach
  ``build_stage_graph``, and the TPC-H goldens still match.
"""

import inspect
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ydb_tpu_torch.ssa import kernels

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _inputs(dtype, device, rows=5000, groups=300, slots=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        vals = torch.rand((rows, slots), generator=g, dtype=torch.float64)
    else:
        vals = torch.randint(-(1 << 40) if dtype == torch.int64 else -1000,
                             (1 << 40) if dtype == torch.int64 else 1000,
                             (rows, slots), generator=g, dtype=torch.int64)
    # ids past the group count are dead rows, as the compiler masks them
    gid = torch.randint(0, groups + 7, (rows,), generator=g,
                        dtype=torch.int32)
    return vals.to(dtype).to(device), gid.to(device), groups


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_int_onehot_past_row_bound_is_exact_scatter(dtype, monkeypatch):
    vals, gid, groups = _inputs(dtype, "cpu")
    want = kernels.fused_group_reduce(vals, gid, groups)  # limb one-hot
    monkeypatch.setattr(kernels, "_INT_LIMB_MAX_ROWS", 64)
    got = kernels.fused_group_reduce(vals, gid, groups)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    # and the plain definition: per-group sums of live rows
    ref = torch.zeros((groups, vals.shape[1]), dtype=torch.int64)
    live = gid < groups
    ref.index_add_(0, gid[live].long(), vals[live].long())
    assert torch.equal(got, ref.to(dtype))


def test_float_onehot_past_row_bound_keeps_matmul(monkeypatch):
    vals, gid, groups = _inputs(torch.float64, "cpu")
    want = kernels.fused_group_reduce(vals, gid, groups)
    monkeypatch.setattr(kernels, "_INT_LIMB_MAX_ROWS", 64)
    got = kernels.fused_group_reduce(vals, gid, groups)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_int_onehot_past_row_bound_on_cuda(dtype, monkeypatch):
    """On the card this raised NotImplementedError before the repair."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vals, gid, groups = _inputs(dtype, "cuda")
    want = kernels.fused_group_reduce(vals, gid, groups)
    monkeypatch.setattr(kernels, "_INT_LIMB_MAX_ROWS", 64)
    got = kernels.fused_group_reduce(vals, gid, groups)
    assert torch.equal(got.cpu(), want.cpu())


def test_dq_env_knobs_reach_stage_graph_and_goldens_match():
    # the child process imports the port only: the golden digest comes
    # over as source text
    from test_torch_sql import digest

    main = textwrap.dedent("""
        GOLDEN = json.load(open(%r))
        import torch
        torch.set_num_threads(1)  # the suite's workers share the cores
        from ydb_tpu_torch import device
        device.DEFAULT_DEVICE = "cpu"
        from ydb_tpu_torch.dq import compute
        from ydb_tpu_torch.plan import executor, execute_plan, to_host
        from ydb_tpu_torch.ssa import plan_fuse
        from ydb_tpu_torch.workload.runner import (scalar_exec_for,
                                                   tpch_database)
        from ydb_tpu_torch.workload import tpch
        from ydb_tpu_torch.workload.queries import TPCH
        from ydb_tpu_torch.sql.parser import parse
        from ydb_tpu_torch.sql.planner import plan_select_full

        assert executor.DQ_TASKS == 3, executor.DQ_TASKS
        assert executor.DQ_BLOCK_ROWS == 4096, executor.DQ_BLOCK_ROWS
        plan_fuse.FUSE_FORCE = False
        seen = []
        real = compute.build_stage_graph

        def spy(stages, parts, rt, *a, **kw):
            seen.append((max(s.tasks for s in stages),
                         kw["block_rows"]))
            return real(stages, parts, rt, *a, **kw)

        compute.build_stage_graph = spy
        data = tpch.TpchData(sf=GOLDEN["sf"], seed=GOLDEN["seed"])
        db, cat = tpch_database(data, device="cpu")
        for name in sorted(TPCH):
            pq = plan_select_full(parse(TPCH[name]), cat,
                                  scalar_exec_for(db))
            res = to_host(execute_plan(pq.plan, db))
            res.dict_aliases = pq.dict_aliases
            want = GOLDEN["queries"][name]
            assert res.num_rows == want["rows"], name
            assert digest(res, data.dicts) == want["sha"], name
        assert len(seen) >= 20, seen
        assert set(seen) == {(3, 4096)}, set(seen)
        print("ok", len(seen))
    """ % os.path.join(HERE, "golden_tpch.json"))
    code = ("import hashlib, json, sys\nimport numpy as np\n"
            + textwrap.dedent(inspect.getsource(digest)) + main
            + "assert 'jax' not in sys.modules\n")
    env = dict(os.environ, YDB_TPU_TORCH_DQ_TASKS="3",
               YDB_TPU_TORCH_DQ_BLOCK_ROWS="4096")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[0] == "ok"


def test_dq_knob_defaults_are_the_references():
    from ydb_tpu_torch.plan import executor

    if "YDB_TPU_TORCH_DQ_TASKS" not in os.environ:
        assert executor.DQ_TASKS == 2
    if "YDB_TPU_TORCH_DQ_BLOCK_ROWS" not in os.environ:
        assert executor.DQ_BLOCK_ROWS == 1 << 20
    assert np.int64(executor.DQ_BLOCK_ROWS) > 0
