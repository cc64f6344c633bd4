"""Distribution data objects.

Ported copy of ``pydcop_tpu/distribution/objects.py`` (itself
pyDCOP's distribution/objects.py: Distribution :36,
DistributionHints :223, ImpossibleDistributionException :269): a
distribution maps agents to the computations they host, and the
hints read from a DCOP YAML file constrain it.
"""

from typing import Dict, Iterable, List, Optional

from pydcop_tpu_torch.utils.simple_repr import SimpleRepr


class ImpossibleDistributionException(Exception):
    pass


class Distribution(SimpleRepr):
    """A mapping agent-name -> list of computation names hosted there.

    >>> d = Distribution({'a1': ['c1', 'c2'], 'a2': ['c3']})
    >>> d.agent_for('c3')
    'a2'
    >>> d.computations_hosted('a1')
    ['c1', 'c2']
    """

    def __init__(self, mapping: Dict[str, List[str]]):
        self._mapping: Dict[str, List[str]] = {
            a: list(cs) for a, cs in mapping.items()
        }

    @property
    def mapping(self) -> Dict[str, List[str]]:
        return {a: list(cs) for a, cs in self._mapping.items()}

    @property
    def agents(self) -> List[str]:
        return list(self._mapping)

    @property
    def computations(self) -> List[str]:
        return [c for cs in self._mapping.values() for c in cs]

    def agent_for(self, computation: str) -> str:
        for a, cs in self._mapping.items():
            if computation in cs:
                return a
        raise KeyError(f"No agent hosts computation {computation}")

    def computations_hosted(self, agent: str) -> List[str]:
        return list(self._mapping.get(agent, []))

    def host_on_agent(self, agent: str, computations: List[str]):
        """Add computations to an agent's hosting list.

        Hosting an already-hosted computation raises (reference
        objects.py:156-175) — a silent duplicate would corrupt
        ``agent_for``; move a computation by rebuilding the mapping.
        """
        hosted = set(self.computations)
        for c in computations:
            if c in hosted:
                raise ValueError(
                    f"Computation {c} is already hosted"
                    + (f" on agent {self.agent_for(c)}"
                       if self.is_hosted(c) else " (duplicate in call)")
                )
            hosted.add(c)
        self._mapping.setdefault(agent, []).extend(computations)

    def is_hosted(self, computations) -> bool:
        if isinstance(computations, str):
            computations = [computations]
        hosted = set(self.computations)
        return all(c in hosted for c in computations)

    def has_computation(self, computation: str) -> bool:
        return computation in set(self.computations)

    def __eq__(self, other):
        return (
            isinstance(other, Distribution)
            and self._mapping == other._mapping
        )

    def __repr__(self):
        return f"Distribution({self._mapping})"

    def _simple_repr(self):
        return {
            "__module__": self.__class__.__module__,
            "__qualname__": self.__class__.__qualname__,
            "mapping": self.mapping,
        }

    @classmethod
    def _from_repr(cls, r):
        return cls(r["mapping"])


class DistributionHints(SimpleRepr):
    """Placement hints: must_host (agent -> comps) and host_with
    (comp -> comps that should be co-located)."""

    def __init__(self, must_host: Optional[Dict[str, List[str]]] = None,
                 host_with: Optional[Dict[str, List[str]]] = None):
        self._must_host = {a: list(c) for a, c in (must_host or {}).items()}
        host_with = host_with or {}
        # host_with is symmetric: close it over all named computations.
        closed: Dict[str, set] = {}
        for c, others in host_with.items():
            group = {c, *others}
            merged = set(group)
            for g in group:
                if g in closed:
                    merged |= closed[g]
            for g in merged:
                closed[g] = merged
        self._host_with = {
            c: sorted(group - {c}) for c, group in closed.items()
        }

    def must_host(self, agent: str) -> List[str]:
        return list(self._must_host.get(agent, []))

    def host_with(self, computation: str) -> List[str]:
        return list(self._host_with.get(computation, []))

    @property
    def must_host_map(self) -> Dict[str, List[str]]:
        return {a: list(c) for a, c in self._must_host.items()}

    def _simple_repr(self):
        return {
            "__module__": self.__class__.__module__,
            "__qualname__": self.__class__.__qualname__,
            "must_host": self.must_host_map,
            "host_with": {c: list(o) for c, o in self._host_with.items()},
        }

    @classmethod
    def _from_repr(cls, r):
        return cls(r.get("must_host"), r.get("host_with"))
