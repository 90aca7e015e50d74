"""Training-curve logging: JSONL scalars and, when it imports, TensorBoard.

The reference logs scalars to tensorboardX (agent_seg.py:742,670-687). The
primary sink is an append-only ``scalars.jsonl`` in the checkpoint
directory (one JSON record per tag and step, with the wall-clock time); a
TensorBoard event file is written too when ``torch.utils.tensorboard``
imports. Under data parallelism only global rank 0 writes: every rank
computes the same global metrics, and the other ranks' writers do
nothing.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

from fpl_plus_torch.parallel.multihost import is_primary_host


class ScalarWriter:
    def __init__(self, log_dir: str):
        self._file = self._tb = None
        if not is_primary_host():
            return
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, 'scalars.jsonl')
        self._file = open(self.path, 'a')
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:     # tensorboard is optional
            return
        self._tb = SummaryWriter(log_dir)

    def add_scalars(self, tag: str, values: Dict[str, float], step: int):
        if self._file is None:
            return
        rec = {'tag': tag, 'step': int(step), 'time': time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._file.write(json.dumps(rec) + '\n')
        self._file.flush()
        if self._tb is not None:
            self._tb.add_scalars(tag, values, step)

    def add_scalar(self, tag: str, value: float, step: int):
        self.add_scalars(tag, {'value': value}, step)

    def close(self):
        if self._file is None:
            return
        self._file.close()
        if self._tb is not None:
            self._tb.close()
