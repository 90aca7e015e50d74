"""Transform base class and shared helpers.

Transforms operate on the sample dict contract (keys: ``image``, ``label``,
``pixel_weight``, ``image1``, ``names``, geometry metadata, and
JSON-encoded ``<Name>_Param`` entries recording the parameters of each
transform's inverse). Mirrors the reference transform
protocol (PyMIC/pymic/transform/abstract_transform.py:4-14).
"""
from __future__ import annotations

import json

import numpy as np

# keys that spatial transforms must modify consistently
SPATIAL_KEYS = ('label', 'pixel_weight', 'image1')


class AbstractTransform(object):
    inverse = False
    _param_prefix = None  # default: class name

    def __init__(self, params):
        self.params = params
        self.task = params.get('task', 'segmentation')

    def __call__(self, sample):
        return sample

    def inverse_transform_for_prediction(self, sample):
        """Undo this transform on ``sample['predict']`` (logits ``[N, K,
        *img]``) on the host."""
        raise ValueError('inverse transform not implemented for {0}'.format(
            type(self).__name__))

    def inverse_selection(self, sample):
        """When this transform's prediction inverse is a PURE spatial
        selection — it keeps a contiguous sub-window of the prediction and
        synthesizes no voxels (e.g. Pad's inverse crop) — return its
        ``(margin_lower, margin_upper)`` per spatial axis for this sample;
        otherwise None. Lets the agent fold the inverse-transform chain
        into one crop of the label map computed on the device."""
        return None

    def cache_safe(self) -> bool:
        """True when this transform is a deterministic function of the
        sample (no random draw, no per-call state), so a dataset may cache
        its output across epochs (``io/dataset.py``). Default: False."""
        return False

    def precompute(self, sample):
        """Hook for a random transform right after a cached deterministic
        prefix: stash a value that is a deterministic function of the
        sample (RandomCrop's foreground box) under a ``<Name>_*`` JSON key
        once per cached item. Draws no random numbers. Default: no-op."""
        return sample

    # -- helpers ----------------------------------------------------------
    def param(self, name, default=..., ):
        """Fetch ``<Prefix>_<name>`` (lower-cased) from the config params."""
        prefix = self._param_prefix or type(self).__name__
        key = '{0}_{1}'.format(prefix, name).lower()
        if default is ...:
            return self.params[key]
        return self.params.get(key, default)

    def store_inverse_param(self, sample, value):
        sample['{0}_Param'.format(type(self).__name__)] = json.dumps(value)
        return sample

    def load_inverse_param(self, sample):
        raw = sample['{0}_Param'.format(type(self).__name__)]
        # after dataloader collation the JSON string arrives wrapped in a list
        if isinstance(raw, (list, tuple, np.ndarray)):
            raw = raw[0]
        return json.loads(raw)


def apply_spatial(sample, fn, task, label_order0_fn=None):
    """Apply ``fn`` to sample['image'] and (for segmentation) to the other
    spatial keys; ``label_order0_fn``, when given, replaces ``fn`` for the
    label map (nearest-neighbour resampling)."""
    sample['image'] = fn(sample['image'])
    if task == 'segmentation':
        if 'label' in sample:
            sample['label'] = (label_order0_fn or fn)(sample['label'])
        for key in SPATIAL_KEYS[1:]:
            if key in sample:
                sample[key] = fn(sample[key])
    return sample
