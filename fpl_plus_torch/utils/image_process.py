"""Host-side label utilities (reference PyMIC/pymic/util/image_process.py),
trimmed to what the test stage uses."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def convert_label(label: np.ndarray, source_list: Sequence[int],
                  target_list: Sequence[int]) -> np.ndarray:
    assert len(source_list) == len(target_list)
    # the output dtype must hold every target code: uint8 argmax maps
    # converted to MMWHS raw codes (205..820) overflow their own dtype
    out_dtype = np.result_type(label.dtype,
                               np.min_scalar_type(int(max(target_list))),
                               np.min_scalar_type(int(min(target_list))))
    out = np.zeros(label.shape, out_dtype)
    for src, tgt in zip(source_list, target_list):
        out[label == src] = tgt
    return out
