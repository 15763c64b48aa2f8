"""Minimal synchronous event emitter (Node's EventEmitter, as ringpop
uses it): a copy of ``ringpop_tpu/utils/events.py``, which ``HashRing``
subclasses."""

from __future__ import annotations

from typing import Any, Callable


class EventEmitter:
    def __init__(self) -> None:
        self._listeners: dict[str, list[Callable[..., Any]]] = {}

    def on(self, event: str, listener: Callable[..., Any]) -> None:
        self._listeners.setdefault(event, []).append(listener)

    def once(self, event: str, listener: Callable[..., Any]) -> None:
        def wrapper(*args: Any) -> None:
            self.remove_listener(event, wrapper)
            listener(*args)

        self.on(event, wrapper)

    def remove_listener(self, event: str, listener: Callable[..., Any]) -> None:
        handlers = self._listeners.get(event)
        if handlers and listener in handlers:
            handlers.remove(listener)

    def remove_all_listeners(self, event: str | None = None) -> None:
        if event is None:
            self._listeners.clear()
        else:
            self._listeners.pop(event, None)

    def emit(self, event: str, *args: Any) -> bool:
        handlers = list(self._listeners.get(event, ()))
        for handler in handlers:
            handler(*args)
        return bool(handlers)

    def listener_count(self, event: str) -> int:
        return len(self._listeners.get(event, ()))
