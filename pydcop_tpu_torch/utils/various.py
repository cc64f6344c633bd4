"""Small shared helpers.

Ported copy of ``pydcop_tpu/utils/various.py``:
the port keeps its own copy, behaviour unchanged.

Reference parity: pydcop/utils/various.py (func_args :34).
"""

import inspect
from typing import Callable, List


def func_args(f: Callable) -> List[str]:
    """Positional argument names of a callable (reference various.py:34).

    >>> func_args(lambda x, y: x + y)
    ['x', 'y']
    """
    try:
        signature = inspect.signature(f)
    except (TypeError, ValueError):
        return []
    return [
        name
        for name, p in signature.parameters.items()
        if p.kind in (
            inspect.Parameter.POSITIONAL_ONLY,
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
        )
    ]
