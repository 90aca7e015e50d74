"""Datasets for the loader's worker-pool tests. This module imports neither
torch nor JAX: the pool's workers import it to unpickle the datasets, and
what they report about their own interpreter must not be caused by it."""
import os
import random
import sys

import numpy as np


class InterpreterProbe:
    """Item i reports the worker's pid, whether torch / jax are imported
    there, and one draw of each seeded RNG."""

    def __init__(self, n: int = 4):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'pid': os.getpid(), 'torch': int('torch' in sys.modules),
                'jax': int('jax' in sys.modules), 'item': i,
                'draw': np.float64(np.random.random() + random.random())}


class FailingAt(InterpreterProbe):
    """Item ``bad`` raises (``how = 'raise'``) or ends its worker process
    (``how = 'exit'``)."""

    def __init__(self, bad: int, how: str, n: int = 6):
        super().__init__(n)
        self.bad, self.how = bad, how

    def __getitem__(self, i):
        if i == self.bad:
            if self.how == 'exit':
                os._exit(3)
            raise ValueError('item {0} is broken'.format(i))
        return super().__getitem__(i)


class Arrays(InterpreterProbe):
    """Item i: a [4, 64, 64] float32 array filled with i (its bytes cross
    in shared memory)."""

    def __getitem__(self, i):
        return {'image': np.full((4, 64, 64), i, np.float32), 'item': i}
