"""Device-trace hooks -- the telemetry layer's bridge to ``torch.profiler``
(counterpart of heat_tpu/telemetry/profiling.py, which drives
``jax.profiler``).

The reference instruments benchmarks with the external ``perun``
runtime/energy monitor (``@monitor()`` decorators, benchmarks/cb/
linalg.py:4,7); the library itself has no tracing (SURVEY.md §5).  Here
the device trace is ``torch.profiler``: CPU activity always, CUDA
activity (every kernel launch and its device time, through CUPTI) when a
card is present.  Host-side structured spans live in
:mod:`heat_tpu_torch.telemetry.spans`, each a ``record_function``, so a
trace taken here attributes the card's kernels to the port's operations.

:func:`start_trace` / :func:`stop_trace` bracket one trace; the stop
writes it as a Chrome-trace JSON artifact (``chrome://tracing``,
https://ui.perfetto.dev) into the directory the start named, and returns
its path.  One trace runs at a time in a process (``torch.profiler``'s
own rule): a second start raises ``RuntimeError``.  The profiler is
entered and left on a thread of its own (``torch.profiler`` must stop on
the thread that started it, and ``/profilez`` starts on one HTTP handler
thread and stops on another or on its deadline timer), recording every
thread's operations (``profile_all_threads``, where the installed torch
has it; the card's kernels are recorded whichever thread launched them).

Also importable as ``heat_tpu_torch.utils.profiling``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import queue
import threading
import time
from typing import Callable, Optional

import torch

__all__ = ["annotate", "monitor", "start_trace", "stop_trace", "trace"]

#: the running trace: (owner thread, its command queue, its reply queue,
#: log_dir, sequence number), under the lock
_ACTIVE = None
_SEQ = 0
_LOCK = threading.Lock()


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _all_threads_config():
    """An experimental config recording every thread's operations, or
    None where the installed torch has no ``profile_all_threads``."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def _owner(commands: "queue.Queue", replies: "queue.Queue") -> None:
    """The trace's thread: enters the profiler, then on the stop command
    leaves it and writes the artifact."""
    try:
        prof = torch.profiler.profile(activities=_activities(), experimental_config=_all_threads_config())
        prof.__enter__()
    except BaseException as e:  # reported to the starting thread
        replies.put(e)
        return
    replies.put(None)
    path = commands.get()
    try:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
    except BaseException as e:  # reported to the stopping thread
        replies.put(e)
        return
    replies.put(path)


def start_trace(log_dir: str) -> None:
    """Begin a ``torch.profiler`` trace whose artifact :func:`stop_trace`
    writes into ``log_dir`` (analog of starting a perun run)."""
    global _ACTIVE, _SEQ
    with _LOCK:
        if _ACTIVE is not None:
            raise RuntimeError(f"a profiler trace is already running (into {_ACTIVE[3]!r})")
        os.makedirs(log_dir, exist_ok=True)
        commands, replies = queue.Queue(), queue.Queue()
        owner = threading.Thread(target=_owner, args=(commands, replies), name="heat-tpu-torch-profiler",
                                 daemon=True)
        owner.start()
        err = replies.get()
        if err is not None:
            owner.join()
            raise RuntimeError(f"torch.profiler failed to start: {err}") from err
        _SEQ += 1
        _ACTIVE = (owner, commands, replies, str(log_dir), _SEQ)


def stop_trace() -> str:
    """End the running trace and write it as Chrome-trace JSON into its
    directory; returns the artifact's path.  Raises ``RuntimeError`` when
    no trace runs."""
    global _ACTIVE
    with _LOCK:
        if _ACTIVE is None:
            raise RuntimeError("no profiler trace is running")
        owner, commands, replies, log_dir, seq = _ACTIVE
        _ACTIVE = None
    commands.put(os.path.join(log_dir, f"trace_{os.getpid()}_{seq:03d}.json"))
    out = replies.get()
    owner.join()
    if isinstance(out, BaseException):
        raise RuntimeError(f"torch.profiler failed to stop: {out}") from out
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Context manager tracing the enclosed region (a no-op without a
    directory)."""
    if log_dir is None:
        yield
        return
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


def annotate(name: str):
    """Named trace region: a ``torch.profiler.record_function``, which
    nests into the trace's timeline."""
    return torch.profiler.record_function(name)


def monitor(name: Optional[str] = None):
    """Decorator measuring wall time of a benchmark function — the drop-in
    analog of perun's ``@monitor()`` (benchmarks/cb/linalg.py:7).  Waits
    for the card on every device the function's output tensors live on
    (tensors and DNDarrays, in nested tuples, lists and dicts), so the
    launch queue does not hide device time.  ``last_runtime`` is set even
    when the wrapped function raises (the elapsed time up to the raise),
    so a failed call can never leave a stale measurement from the
    previous call behind.
    """

    def deco(fn: Callable):
        label = name or fn.__name__

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(label):
                    out = fn(*args, **kwargs)
                    for dev in _cuda_devices(out):
                        torch.cuda.synchronize(dev)
                return out
            finally:
                wrapped.last_runtime = time.perf_counter() - t0

        wrapped.last_runtime = None
        return wrapped

    return deco


def _cuda_devices(x, depth: int = 0) -> set:
    """The CUDA devices of the tensors in ``x``."""
    out = set()
    larray = getattr(x, "larray", None)
    if isinstance(larray, torch.Tensor):
        x = larray
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif depth < 8 and isinstance(x, (tuple, list)):
        for v in x:
            out |= _cuda_devices(v, depth + 1)
    elif depth < 8 and isinstance(x, dict):
        for v in x.values():
            out |= _cuda_devices(v, depth + 1)
    return out
