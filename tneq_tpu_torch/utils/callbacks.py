"""Training/search callbacks and experiment recording.

Counterpart of ``tneq_tpu/utils/callbacks.py`` (pure Python, copied).
Equivalent of the reference's ``callbacks.py`` (``CALLBACKS`` classes whose
methods fire on events; ``OVERLOAD.record_experiment`` joblib dump): a small
explicit callback registry plus pickle/JSON experiment records — without the
reference's call-all-methods-on-init quirk (``callbacks.py:44-50``).
"""

from __future__ import annotations

import json
import pickle
import time
from dataclasses import asdict, is_dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List

__all__ = ["CallbackList", "ExperimentRecorder"]


class CallbackList:
    """Ordered event callbacks: ``on(event, fn)`` registers, ``fire(event,
    **ctx)`` invokes in order, collecting (and not raising) errors."""

    def __init__(self):
        self._callbacks: Dict[str, List[Callable]] = {}
        self.errors: List[str] = []

    def on(self, event: str, fn: Callable) -> "CallbackList":
        self._callbacks.setdefault(event, []).append(fn)
        return self

    def fire(self, event: str, **ctx: Any) -> None:
        for fn in self._callbacks.get(event, []):
            try:
                fn(**ctx)
            except Exception as e:  # callbacks must not kill training
                self.errors.append(f"{event}/{fn.__name__}: {e}")


class ExperimentRecorder:
    """Persist experiment configs + results
    (reference ``OVERLOAD.record_experiment``, ``callbacks.py:75-81``)."""

    def __init__(self, directory):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def _json_default(obj: Any):
        import numpy as np

        if isinstance(obj, (np.integer, np.floating)):
            return obj.item()
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        raise TypeError(f"{type(obj).__name__} is not JSON-serializable")

    def record(self, name: str, payload: Any) -> Path:
        stamp = time.strftime("%Y%m%d_%H%M%S")
        if is_dataclass(payload) and not isinstance(payload, type):
            payload = asdict(payload)
        try:
            text = json.dumps(payload, indent=2, default=self._json_default)
            path = self.directory / f"{name}_{stamp}.json"
            path.write_text(text)
        except TypeError:
            path = self.directory / f"{name}_{stamp}.pkl"
            with open(path, "wb") as f:
                pickle.dump(payload, f)
        return path

    def load(self, path) -> Any:
        path = Path(path)
        if path.suffix == ".json":
            return json.loads(path.read_text())
        with open(path, "rb") as f:
            return pickle.load(f)
