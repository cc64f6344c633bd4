"""Dynamic-DCOP event scripts.

Reference parity: pydcop/dcop/scenario.py (EventAction :37, DcopEvent :55,
Scenario :95); YAML format docs/usage/file_formats/scenario_format.yml.
"""

from typing import Dict, Iterable, List, Optional

from pydcop_tpu_torch.utils.simple_repr import SimpleRepr


class EventAction(SimpleRepr):
    """A single action in an event: e.g. remove_agent / add_agent."""

    def __init__(self, type: str, **args):
        self._type = type
        self._args = dict(args)

    @property
    def type(self) -> str:
        return self._type

    @property
    def args(self) -> Dict:
        return dict(self._args)

    def _simple_repr(self):
        r = {
            "__module__": self.__class__.__module__,
            "__qualname__": self.__class__.__qualname__,
            "type": self._type,
        }
        r.update(self._args)
        return r

    @classmethod
    def _from_repr(cls, r):
        args = {k: v for k, v in r.items()
                if k != "type" and not k.startswith("__")}
        return cls(r["type"], **args)

    def __repr__(self):
        return f"EventAction({self._type}, {self._args})"

    def __eq__(self, other):
        return (
            isinstance(other, EventAction)
            and self._type == other._type
            and self._args == other._args
        )


class DcopEvent(SimpleRepr):
    """An event: either a delay or a list of simultaneous actions."""

    def __init__(self, id: str, delay: Optional[float] = None,
                 actions: Optional[List[EventAction]] = None):
        self._id = id
        self._delay = delay
        self._actions = actions

    @property
    def id(self) -> str:
        return self._id

    @property
    def delay(self) -> Optional[float]:
        return self._delay

    @property
    def actions(self) -> Optional[List[EventAction]]:
        return self._actions

    @property
    def is_delay(self) -> bool:
        return self._delay is not None

    def __repr__(self):
        if self.is_delay:
            return f"DcopEvent(delay {self._delay})"
        return f"DcopEvent({self._id}, {self._actions})"

    def __eq__(self, other):
        return (
            isinstance(other, DcopEvent)
            and self._id == other._id
            and self._delay == other._delay
            and self._actions == other._actions
        )


class Scenario(SimpleRepr):
    """An ordered list of events applied to a running DCOP."""

    def __init__(self, events: Optional[Iterable[DcopEvent]] = None):
        self._events = list(events) if events else []

    @property
    def events(self) -> List[DcopEvent]:
        return list(self._events)

    def add_event(self, event: DcopEvent):
        self._events.append(event)

    def __iter__(self):
        return iter(self._events)

    def __len__(self):
        return len(self._events)
