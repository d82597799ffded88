"""Early stopping on validation loss: a patience counter and the best
snapshot. Counterpart of ``rtdm_tpu/utils/early_stopping.py``."""

from __future__ import annotations

from typing import Any, Optional


class EarlyStopping:
    def __init__(self, patience: int = 20, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best_loss = float("inf")
        self.counter = 0
        self.should_stop = False
        self.best_state: Optional[Any] = None

    def __call__(self, val_loss: float, state: Optional[Any] = None) -> bool:
        """Returns True if this epoch improved the best loss."""
        if val_loss < self.best_loss - self.min_delta:
            self.best_loss = val_loss
            self.counter = 0
            if state is not None:
                self.best_state = state
            return True
        self.counter += 1
        if self.counter >= self.patience:
            self.should_stop = True
        return False
