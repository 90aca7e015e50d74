"""Hyperparameter ramps (reference PyMIC/pymic/util/ramps.py:12-56; the JAX
package's ``utils/ramps.py``): the ratio in [0, 1] of iteration ``i``
between ``start`` and ``end``, linear, sigmoid (``exp(-5 phase^2)``) or
cosine. Numpy only."""
from __future__ import annotations

import numpy as np


def get_rampup_ratio(i, start, end, mode='linear') -> float:
    i = np.clip(i, start, end)
    if mode == 'linear':
        return float((i - start) / (end - start))
    if mode == 'sigmoid':
        phase = 1.0 - (i - start) / (end - start)
        return float(np.exp(-5.0 * phase * phase))
    if mode == 'cosine':
        phase = 1.0 - (i - start) / (end - start)
        return float(.5 * (np.cos(np.pi * phase) + 1))
    raise ValueError('Undefined rampup mode {0}'.format(mode))


def get_rampdown_ratio(i, start, end, mode='linear') -> float:
    i = np.clip(i, start, end)
    if mode == 'linear':
        return float(1.0 - (i - start) / (end - start))
    if mode == 'sigmoid':
        phase = (i - start) / (end - start)
        return float(np.exp(-5.0 * phase * phase))
    if mode == 'cosine':
        phase = (i - start) / (end - start)
        return float(.5 * (np.cos(np.pi * phase) + 1))
    raise ValueError('Undefined rampup mode {0}'.format(mode))
