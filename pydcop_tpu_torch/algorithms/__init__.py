"""Algorithm plugin machinery: descriptors and parameter validation.

Port of ``pydcop_tpu/algorithms/__init__.py`` (AlgoParameterDef,
AlgorithmDef, check_param_value, prepare_algo_params,
load_algorithm_module, list_available_algorithms) without the
agent-mode computation definitions: the port runs algorithms on the
device only.  An algorithm module here declares ``algo_params``,
``GRAPH_TYPE`` and ``solve_on_device``.
"""

import importlib
import pkgutil
from typing import Any, Dict, List, NamedTuple, Optional

from pydcop_tpu_torch.utils.simple_repr import SimpleRepr


class AlgoParameterDef(NamedTuple):
    """Declaration of one algorithm parameter."""

    name: str
    type: str                       # 'str' | 'int' | 'float' | 'bool'
    values: Optional[List] = None   # allowed values, or None
    default_value: Any = None


class AlgoParameterException(Exception):
    pass


def check_param_value(value: Any, param_def: AlgoParameterDef) -> Any:
    """Coerce and validate a parameter value against its definition."""
    if value is None:
        return param_def.default_value
    try:
        if param_def.type == "int":
            value = int(value)
        elif param_def.type == "float":
            value = float(value)
        elif param_def.type == "bool":
            if isinstance(value, str):
                value = value.lower() in ("true", "1", "yes")
            else:
                value = bool(value)
        elif param_def.type == "str":
            value = str(value)
    except (ValueError, TypeError):
        raise AlgoParameterException(
            f"Invalid value {value!r} for parameter {param_def.name} "
            f"of type {param_def.type}"
        )
    if param_def.values is not None and value not in param_def.values:
        raise AlgoParameterException(
            f"Value {value!r} for parameter {param_def.name} not in "
            f"allowed values {param_def.values}"
        )
    return value


def prepare_algo_params(params: Dict[str, Any],
                        params_defs: List[AlgoParameterDef]
                        ) -> Dict[str, Any]:
    """Full parameter dict: given values validated, defaults filled in.
    Unknown parameter names raise."""
    defs = {p.name: p for p in params_defs}
    unknown = set(params) - set(defs)
    if unknown:
        raise AlgoParameterException(
            f"Unknown algorithm parameter(s): {sorted(unknown)}; "
            f"supported: {sorted(defs)}"
        )
    out = {}
    for name, pdef in defs.items():
        out[name] = check_param_value(params.get(name), pdef)
    return out


class AlgorithmDef(SimpleRepr):
    """An algorithm selection: name + validated params + objective mode."""

    def __init__(self, algo: str, params: Dict[str, Any],
                 mode: str = "min"):
        self._algo = algo
        self._params = dict(params)
        self._mode = mode

    @classmethod
    def build_with_default_param(cls, algo: str,
                                 params: Optional[Dict] = None,
                                 mode: str = "min",
                                 parameters_definitions:
                                 Optional[List[AlgoParameterDef]] = None,
                                 ) -> "AlgorithmDef":
        if parameters_definitions is None:
            module = load_algorithm_module(algo)
            parameters_definitions = module.algo_params
        full = prepare_algo_params(params or {}, parameters_definitions)
        return cls(algo, full, mode)

    @property
    def algo(self) -> str:
        return self._algo

    @property
    def params(self) -> Dict[str, Any]:
        return dict(self._params)

    @property
    def mode(self) -> str:
        return self._mode

    def param_value(self, name: str) -> Any:
        return self._params[name]

    def __eq__(self, other):
        return (
            isinstance(other, AlgorithmDef)
            and self._algo == other._algo
            and self._params == other._params
            and self._mode == other._mode
        )

    def __repr__(self):
        return f"AlgorithmDef({self._algo}, {self._params}, {self._mode})"


def load_algorithm_module(name: str):
    """Import an algorithm module of this package (an empty
    ``algo_params`` is injected when the module declares none)."""
    module = importlib.import_module(f"pydcop_tpu_torch.algorithms.{name}")
    if not hasattr(module, "algo_params"):
        module.algo_params = []
    return module


def list_available_algorithms() -> List[str]:
    """All algorithm modules in this package (plugin discovery)."""
    import pydcop_tpu_torch.algorithms as pkg

    return sorted(
        name
        for _, name, ispkg in pkgutil.iter_modules(pkg.__path__)
        if not ispkg and not name.startswith("_")
    )
