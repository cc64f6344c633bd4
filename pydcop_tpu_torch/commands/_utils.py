"""Shared CLI helpers.

Ported copy of ``pydcop_tpu/commands/_utils.py``:
the port keeps its own copy, behaviour unchanged.

Reference parity: pydcop/commands/_utils.py (build_algo_def, module
loading, algo-params parsing).
"""

import json
from typing import Dict, List, Optional

import numpy as np

from pydcop_tpu_torch.algorithms import AlgorithmDef


def parse_algo_params(param_strs: Optional[List[str]]) -> Dict[str, str]:
    """Parse repeated ``name:value`` CLI parameters."""
    params: Dict[str, str] = {}
    for p in param_strs or []:
        if ":" not in p:
            raise ValueError(
                f"Invalid algo parameter {p!r}: expected name:value"
            )
        name, value = p.split(":", 1)
        params[name.strip()] = value.strip()
    return params


def build_algo_def(algo: str, params_strs: Optional[List[str]],
                   objective: str) -> AlgorithmDef:
    return AlgorithmDef.build_with_default_param(
        algo, parse_algo_params(params_strs), mode=objective
    )


class _NumpyEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        return json.JSONEncoder.default(self, o)


def emit_result(result: dict, output_file: Optional[str] = None):
    """Print results JSON to stdout (and optionally a file), matching the
    reference output shape (commands/solve.py:611-632)."""
    text = json.dumps(result, sort_keys=True, indent="  ",
                      cls=_NumpyEncoder)
    if output_file:
        with open(output_file, "w", encoding="utf-8") as f:
            f.write(text)
    print(text)
