"""Plan lowering to the DQ stage graph (``dq_lower.py``)."""
