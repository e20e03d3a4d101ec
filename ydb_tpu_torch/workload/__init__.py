"""Workload generators and queries as SSA programs (TPC-H, ClickBench)."""
