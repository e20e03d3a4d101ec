"""Static analysis of SSA programs: the typed verifier (``verify``) and its
diagnostics, copied from ``ydb_tpu/analysis``."""
