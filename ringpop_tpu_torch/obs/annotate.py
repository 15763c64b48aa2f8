"""Profiler scopes and trace brackets for the protocol's phases.

The port of ``ringpop_tpu/obs/annotate.py``.  ``scope(name)`` is
``torch.profiler.record_function(name)``: every op a phase runs, on the
host and on the card, lands under that name in a ``torch.profiler``
trace, so the trace reads as protocol phases (phase-0/1 select, the
receiver merge, the ping-req exchange, the delta absorb and compact)
under the reference's scope names.  With no profiler running a scope
costs about a microsecond.

``profile_trace(dir)`` brackets a block with ``torch.profiler`` (the
CPU and, where a card is visible, CUDA activities) and writes the
Chrome trace-event JSON that Perfetto and TensorBoard load into
``dir``: the implementation behind ``tick-cluster --profile-dir``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Callable, Iterator

import torch


def scope(name: str) -> Any:
    """Context manager: a ``torch.profiler.record_function`` for one
    protocol phase."""
    return torch.profiler.record_function(name)


def scoped(name: str) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    """Decorator form of ``scope`` (wraps the whole function body)."""

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def profile_trace(directory: str) -> Iterator[str]:
    """Bracket a block with a ``torch.profiler`` trace written to
    ``directory`` (created if missing) as ``trace-<pid>-<ms>.json``.
    The profiler stops and the file is written even when the block
    raises, so a crashed run still ships its trace."""
    os.makedirs(directory, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield directory
    finally:
        prof.stop()
        name = f"trace-{os.getpid()}-{int(time.time() * 1000)}.json"
        prof.export_chrome_trace(os.path.join(directory, name))
