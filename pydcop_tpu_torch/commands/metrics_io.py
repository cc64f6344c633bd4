"""CSV metrics output with the reference's column schema.

Port of ``pydcop_tpu/commands/metrics_io.py`` (the writers behind
``solve --run_metrics`` / ``--end_metrics`` with ``--collect_on``).
"""

import csv
import os
from typing import Dict

COLUMNS = [
    "time", "cycle", "cost", "violation", "msg_count", "msg_size",
    "status",
]


def add_csvline(path: str, collect_on: str, metrics: Dict):
    """Append one row of ``metrics`` (missing columns empty) to the CSV
    at ``path``, writing the header first when the file is new."""
    exists = os.path.exists(path)
    with open(path, "a", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        if not exists:
            writer.writerow(COLUMNS)
        writer.writerow([metrics.get(c, "") for c in COLUMNS])
