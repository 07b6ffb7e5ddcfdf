"""Estimator base classes, and the resumable-fit machinery the iterative
estimators build on (``checkpoint_every`` / ``checkpoint_dir`` /
``resume_from``; counterpart of heat_tpu/core/base.py)."""

from __future__ import annotations

import inspect
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _env

__all__ = [
    "BaseEstimator",
    "ClassificationMixin",
    "ClusteringMixin",
    "RegressionMixin",
    "TransformMixin",
    "is_classifier",
    "is_estimator",
    "is_clusterer",
    "is_regressor",
    "is_transformer",
    "lazy_scalar_property",
    "low_precision_predict_requested",
    "resumable_fit_loop",
    "validate_resume_params",
]

_NATIVE_PREDICT = ("", "0", "off", "float32", "f32", "native")


def low_precision_predict_requested() -> bool:
    """True where ``HEAT_TPU_PREDICT_DTYPE`` asks predict and transform for a
    low-precision compute type (not ported yet: callers raise)."""
    return _env.env_str("HEAT_TPU_PREDICT_DTYPE").strip().lower() not in _NATIVE_PREDICT


def _sample_rows(x, *aligned):
    """``(rows, [entries], reduce)`` for an estimator's sums over samples:
    where x is split along its rows over several ranks, this rank's rows of
    x, each ``aligned`` array's entries (flattened) for those rows and the
    all-reduce of a sum; else the whole arrays and the identity.  An
    aligned None stays None."""
    if x.split == 0 and x.comm.size > 1:
        lo, rows = x.comm.chunk(x.shape, 0)[0], x.lshape[0]

        def mine(v):
            if v is None:
                return None
            if v.split == 0 and v.shape[0] == x.shape[0]:  # the same canonical rows
                return v.larray.reshape(-1)
            return v._dense().reshape(-1)[lo:lo + rows]

        return x.larray, [mine(v) for v in aligned], x.comm.psum
    return x._dense(), [None if v is None else v._dense().reshape(-1) for v in aligned], (lambda t: t)


def validate_resume_params(
    checkpoint_every: Optional[int],
    checkpoint_dir: Optional[str],
    resume_from: Optional[str],
) -> None:
    """Shared constructor validation of the resumable-fit parameters."""
    if checkpoint_every is not None:
        if not isinstance(checkpoint_every, int) or checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be a positive int, got {checkpoint_every!r}"
            )
        if checkpoint_dir is None and resume_from is None:
            raise ValueError(
                "checkpoint_every requires checkpoint_dir (or resume_from) "
                "to name the checkpoint directory"
            )


def _host_iterate(state):
    """A last-good iterate for :class:`DivergenceError`: a dict passes
    through, a tensor comes to the host as numpy."""
    if isinstance(state, dict):
        return state
    if isinstance(state, torch.Tensor):
        state = state.detach().cpu()
        return (state.float() if state.dtype == torch.bfloat16 else state).numpy()
    return np.asarray(state)


def resumable_fit_loop(
    run_chunk: Callable,
    init_state: Callable,
    max_iter: int,
    tol: float,
    checkpoint_every: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    resume_from: Optional[str] = None,
    site: str = "estimator.iter",
    what: str = "iterate",
    converged_when: Optional[Callable[[float, float], bool]] = None,
    exhausted_converges: bool = True,
    comm=None,
) -> Tuple[object, int]:
    """Drive a fit loop in resumable, divergence-guarded chunks.

    With ``checkpoint_every=N`` the fit's loop runs in chunks of N
    iterations, and between chunks the iterate is offered to the fault
    injector (site ``<estimator>.iter``, the hook kill-and-resume tests
    script), checked finite (:class:`DivergenceError` carrying the last
    good iterate on NaN/Inf) and checkpointed through the native
    :class:`~heat_tpu_torch.utils.checkpoint.Checkpointer`.  The iteration
    sequence is the uninterrupted loop's, so a killed fit resumed from its
    last checkpoint reproduces the uninterrupted result exactly.

    ``run_chunk(state, n)`` runs at most ``n`` iterations from ``state`` (a
    tensor, or the numpy array a checkpoint restored) and returns
    ``(new_state, iters_run, shift)``; ``init_state()`` builds the initial
    iterate (only called when not resuming, so the random draws of an
    initialisation are not replayed on resume).  ``converged_when(shift,
    tol)`` must mirror the fit's own stop test (default ``shift <= tol``),
    so that a chunk boundary never stops the fit one iteration early or
    late.  Returns ``(final_state, total_iterations)``.  ``comm`` is the
    communication the fit runs on: its ranks checkpoint together.

    Checkpoint writes are asynchronous by default
    (:class:`~heat_tpu_torch.utils.overlap.AsyncCheckpointer`): chunk k's
    write runs on a background writer while chunk k+1 computes, and the
    loop drains it (``wait()``) before the next boundary's fault site, so a
    kill at boundary k+1 always finds chunk k durable, and the loop never
    returns before its last checkpoint is committed.
    ``HEAT_TPU_ASYNC_CKPT=0`` makes every save synchronous.  After the save
    the boundary polls the process-wide
    :class:`~heat_tpu_torch.core.preempt.PreemptionGate`: a pending request
    stops a checkpointing fit with :class:`PreemptedError` (the
    ``qos.preempt`` site fires first), and is refused (counted) for a fit
    without checkpoints.

    ``exhausted_converges`` says what a short chunk (``iters_run < n``)
    means: by default that the fit's own stop test fired inside it; with
    False, that the input ran dry, so the loop checkpoints
    ``converged=False`` and returns.

    With ``HEAT_TPU_HEARTBEAT_FILE`` set every chunk boundary touches that
    file: the liveness signal of the elastic process supervisor."""
    import sys as _sys
    import time as _time

    from ..resilience.errors import DivergenceError, PreemptedError
    from ..resilience.faults import inject
    from ..resilience.guard import all_finite
    from ..telemetry import metrics as _tm
    from ..telemetry.spans import span as _span
    from ..utils.checkpoint import Checkpointer
    from ..utils.overlap import async_checkpoint_enabled
    from .preempt import preemption_gate

    # the fit's heartbeat: iterations/s of the last chunk, its convergence
    # delta and the time of the last boundary
    iter_rate_g = _tm.gauge("fit.iter_rate", "iterations/s of the last fit chunk")
    shift_g = _tm.gauge("fit.shift", "convergence delta of the last fit chunk")
    heartbeat_g = _tm.gauge(
        "fit.heartbeat_ts", "unix time of the last resumable-fit chunk boundary"
    )
    hb_file = _env.env_str("HEAT_TPU_HEARTBEAT_FILE")

    def _beat() -> None:
        heartbeat_g.set(_time.time())
        if hb_file:
            try:
                os.close(os.open(hb_file, os.O_CREAT | os.O_WRONLY, 0o644))
                os.utime(hb_file, None)
            except OSError:
                pass  # the liveness signal is best effort; never fail the fit

    ckpt = None
    directory = checkpoint_dir or resume_from
    if directory is not None and checkpoint_every is not None:
        ckpt = Checkpointer(directory, comm=comm)
        if async_checkpoint_enabled():
            ckpt = ckpt.as_async()

    state = None
    total = 0
    if resume_from is not None:
        reader = ckpt if ckpt is not None else Checkpointer(resume_from, comm=comm)
        step = reader.latest_step()
        if step is not None:
            saved = reader.restore(step)
            state = saved["state"]
            total = int(saved["n_iter"])
            if saved.get("converged") or total >= max_iter:
                return state, total
    if state is None:
        state = init_state()

    chunk = checkpoint_every if checkpoint_every is not None else max_iter
    stop_test = converged_when if converged_when is not None else (lambda s, t: s <= t)
    last_good = (state, total)
    try:
        while total < max_iter:
            n = min(chunk, max_iter - total)
            _beat()  # entering a chunk counts as alive
            t0 = _time.perf_counter()
            with _span("fit.chunk", site=site) as sp:
                new_state, iters_run, shift_run = run_chunk(state, n)
                iters = int(iters_run)
                shift = float(shift_run)
            elapsed = _time.perf_counter() - t0
            sp.attrs.update(iters=iters, shift=shift, total=total + iters)
            _beat()
            iter_rate_g.set(iters / elapsed if elapsed > 0 else 0.0)
            shift_g.set(shift)
            total += iters
            if ckpt is not None:
                # the previous chunk's write overlapped this chunk: drain it
                # before the boundary, so a scripted kill here finds it durable
                ckpt.wait()
            inject(site, iteration=total)
            if not all_finite(new_state):
                raise DivergenceError(
                    f"non-finite values in {what} at iteration {total} — the fit "
                    f"has diverged; last finite {what} is at iteration {last_good[1]}",
                    iteration=total,
                    last_good=_host_iterate(last_good[0]),
                    last_good_iteration=last_good[1],
                )
            state = new_state
            short_chunk = iters < n
            converged = stop_test(shift, tol) or (exhausted_converges and short_chunk)
            if ckpt is not None:
                ckpt.save(
                    total,
                    {
                        "state": state,
                        "n_iter": total,
                        "shift": shift,
                        "converged": bool(converged),
                    },
                )
            if converged or short_chunk:
                break
            # the preemption poll: after the boundary's checkpoint is
            # scheduled, so that the pause is durable; a fit without
            # checkpoints refuses (take(durable=False) counts the refusal)
            preempt_reason = preemption_gate().take(durable=ckpt is not None)
            if preempt_reason is not None:
                inject("qos.preempt", iteration=total, reason=preempt_reason)
                raise PreemptedError(
                    f"{what} fit preempted at iteration {total} "
                    f"({preempt_reason}); resume from {directory!r} to "
                    "continue the identical iteration sequence",
                    iteration=total,
                    checkpoint_dir=directory,
                    reason=preempt_reason,
                )
            last_good = (state, total)
    finally:
        if ckpt is not None:
            if _sys.exc_info()[0] is None:
                ckpt.close()  # the last write is durable before the fit returns
            else:
                try:  # the body's exception wins over a late writer error
                    ckpt.close()
                except BaseException:
                    pass
    return state, total


def lazy_scalar_property(attr: str, kind: type = float, doc: Optional[str] = None) -> property:
    """Property that turns a stored device scalar into a host ``kind`` on
    first access and caches it, so a fit never waits on the device for it."""

    def fget(self):
        v = getattr(self, attr)
        if v is not None and not isinstance(v, kind):
            v = kind(v)
            setattr(self, attr, v)
        return v

    def fset(self, value):
        setattr(self, attr, value)

    return property(fget, fset, doc=doc or f"Lazy host {kind.__name__} of ``{attr}``.")


class BaseEstimator:
    """sklearn-style estimator base: parameters are the ``__init__`` arguments."""

    @classmethod
    def _parameter_names(cls) -> List[str]:
        init = cls.__init__
        if init is object.__init__:
            return []
        sig = inspect.signature(init)
        return [
            name
            for name, p in sig.parameters.items()
            if name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        ]

    def get_params(self, deep: bool = True) -> Dict:
        """Parameters of this estimator."""
        params = {}
        for key in self._parameter_names():
            value = getattr(self, key, None)
            if deep and hasattr(value, "get_params"):
                for sub_key, sub_value in value.get_params().items():
                    params[f"{key}__{sub_key}"] = sub_value
            params[key] = value
        return params

    def set_params(self, **params) -> "BaseEstimator":
        """Set estimator parameters."""
        if not params:
            return self
        valid = self.get_params(deep=True)
        for key, value in params.items():
            key, _, sub_key = key.partition("__")
            if key not in valid:
                raise ValueError(f"Invalid parameter {key} for estimator {self}.")
            if sub_key:
                valid[key].set_params(**{sub_key: value})
            else:
                setattr(self, key, value)
        return self

    def __repr__(self) -> str:
        params = ", ".join(f"{k}={v!r}" for k, v in self.get_params(deep=False).items())
        return f"{self.__class__.__name__}({params})"


class ClusteringMixin:
    """fit / fit_predict protocol of clusterers."""

    def fit(self, x):
        raise NotImplementedError()

    def fit_predict(self, x):
        self.fit(x)
        return self.predict(x)


class ClassificationMixin:
    """fit / predict protocol of classifiers."""

    def fit(self, x, y):
        raise NotImplementedError()

    def fit_predict(self, x, y):
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x):
        raise NotImplementedError()


class TransformMixin:
    """fit / transform protocol of transformers."""

    def fit(self, x):
        raise NotImplementedError()

    def fit_transform(self, x):
        return self.fit(x).transform(x)

    def transform(self, x):
        raise NotImplementedError()


class RegressionMixin:
    """fit / predict protocol of regressors."""

    def fit(self, x, y):
        raise NotImplementedError()

    def fit_predict(self, x, y):
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x):
        raise NotImplementedError()


def is_classifier(estimator) -> bool:
    """True for classifiers."""
    return isinstance(estimator, ClassificationMixin)


def is_estimator(estimator) -> bool:
    """True for estimators."""
    return isinstance(estimator, BaseEstimator)


def is_clusterer(estimator) -> bool:
    """True for clusterers."""
    return isinstance(estimator, ClusteringMixin)


def is_regressor(estimator) -> bool:
    """True for regressors."""
    return isinstance(estimator, RegressionMixin)


def is_transformer(estimator) -> bool:
    """True for transformers."""
    return isinstance(estimator, TransformMixin)
