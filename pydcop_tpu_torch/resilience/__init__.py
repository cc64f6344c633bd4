"""Resilience of the device solve: checkpoint/resume and guarded
segments with rollback-and-recover (port of the engine half of
``pydcop_tpu/resilience``: ``checkpoint.py`` and ``recovery.py``)."""
