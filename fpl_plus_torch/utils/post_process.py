"""Post-processing registry (reference PyMIC/pymic/util/post_process.py:9-48).

``PostKeepLargestComponent``: mode 1 keeps the largest component of the
foreground union; mode 2 keeps the largest component per class. The
reference's ``__call__`` returns the unmodified ``seg`` in mode 2 (it builds
``output`` then returns ``seg``); like the JAX package, mode 2 here returns
the processed output.
"""
from __future__ import annotations

import numpy as np

from fpl_plus_torch.utils.image_process import get_largest_k_components


class PostProcess:
    def __init__(self, params):
        self.params = params

    def __call__(self, seg):
        return seg


class PostKeepLargestComponent(PostProcess):
    def __init__(self, params):
        super().__init__(params)
        self.mode = params.get('keeplargestcomponent_mode', 1)

    def __call__(self, seg):
        if self.mode == 1:
            mask = np.asarray(seg > 0, np.uint8)
            mask = get_largest_k_components(mask)
            seg = seg * mask
        elif self.mode == 2:
            class_num = int(seg.max())
            output = np.zeros_like(seg)
            for c in range(1, class_num + 1):
                seg_c = np.asarray(seg == c, np.uint8)
                seg_c = get_largest_k_components(seg_c)
                output = output + seg_c * c
            seg = output
        return seg


PostProcessDict = {
    'KeepLargestComponent': PostKeepLargestComponent,
}
