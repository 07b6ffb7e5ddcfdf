"""Optimizer utilities (counterpart of heat_tpu/optim/utils.py, itself heat's
optim/utils.py): plain Python, the same in both packages."""

from __future__ import annotations

from typing import Dict

__all__ = ["DetectMetricPlateau"]


class DetectMetricPlateau:
    """Detect when a tracked metric plateaus (heat's optim/utils.py:14).

    Keeps heat's get_state/set_state checkpoint hooks (:72-108).
    """

    def __init__(self, mode: str = "min", patience: int = 10, threshold: float = 1e-4, threshold_mode: str = "rel"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode} is unknown")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold mode {threshold_mode} is unknown")
        self.mode = mode
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.best = None
        self.num_bad_epochs = None
        self.mode_worse = float("inf") if mode == "min" else -float("inf")
        self.reset()

    def reset(self) -> None:
        """Reset the tracker (optim/utils.py:60)."""
        self.best = self.mode_worse
        self.num_bad_epochs = 0

    def get_state(self) -> Dict:
        """Checkpointable state dict (optim/utils.py:72)."""
        return {
            "mode": self.mode,
            "patience": self.patience,
            "threshold": self.threshold,
            "threshold_mode": self.threshold_mode,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "mode_worse": self.mode_worse,
        }

    def set_state(self, state: Dict) -> None:
        """Restore from a state dict (optim/utils.py:90)."""
        for k, v in state.items():
            setattr(self, k, v)

    def is_better(self, a, best) -> bool:
        """Comparison under mode/threshold (optim/utils.py:110)."""
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < best * (1.0 - self.threshold)
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def test_if_improving(self, metric) -> bool:
        """Track one value; True if the metric has plateaued
        (optim/utils.py:130)."""
        current = float(metric)
        if self.is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            return True
        return False
