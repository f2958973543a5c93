"""Trainable: the class API an ``Algorithm`` is built on (the port's own
copy of the parts of ``ray_tpu/tune/trainable.py`` that ``Algorithm``
uses).

``train()`` runs ``step()`` and then counts the iteration; ``save`` and
``restore`` write and read the same ``trainable.pkl`` payload as JAX's
(``{"data": save_checkpoint(...), "iteration": n}``). The Tune
controller, the trial runner and ``FunctionTrainable`` are not ported.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, Optional

DONE = "done"
TRAINING_ITERATION = "training_iteration"


class Trainable:
    """Class API: subclass and implement ``setup``/``step`` (and optionally
    ``save_checkpoint``/``load_checkpoint``)."""

    def __init__(self, config: Dict[str, Any]):
        self.config = config
        self._iteration = 0
        self._start_time = time.time()
        self.setup(config)

    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        return None

    def load_checkpoint(self, checkpoint: Dict) -> None:
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        return False

    def cleanup(self) -> None:
        pass

    def train(self) -> Dict[str, Any]:
        result = self.step()
        self._iteration += 1
        result.setdefault(DONE, False)
        result[TRAINING_ITERATION] = self._iteration
        result.setdefault("time_total_s", time.time() - self._start_time)
        return result

    def save(self, checkpoint_dir: str) -> Optional[str]:
        os.makedirs(checkpoint_dir, exist_ok=True)
        data = self.save_checkpoint(checkpoint_dir)
        path = os.path.join(checkpoint_dir, "trainable.pkl")
        with open(path, "wb") as f:
            pickle.dump({"data": data, "iteration": self._iteration}, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        path = os.path.join(checkpoint_dir, "trainable.pkl")
        with open(path, "rb") as f:
            payload = pickle.load(f)
        self._iteration = payload["iteration"]
        if payload["data"] is not None:
            self.load_checkpoint(payload["data"])
