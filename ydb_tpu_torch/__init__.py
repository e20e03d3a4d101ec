"""ydb_tpu_torch — the PyTorch/CUDA port of ``ydb_tpu``.

A second package beside the JAX reference: the columnar SSA scan path
(blocks, program compiler, kernels, scan executor, TPC-H and ClickBench
workloads) on torch tensors, with the reference's two Pallas group-by
kernels rewritten as hand-written CUDA for Hopper
(``ydb_tpu_torch/csrc/grouped_sum.cu``). It imports torch and numpy,
never jax and nothing of ``ydb_tpu``. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
