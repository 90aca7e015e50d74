"""High-level volume loading/saving on the sample-dict contract.

API parity with the reference loader
(PyMIC/pymic/io/image_read_write.py:69-148):
``load_image_as_nd_array`` returns ``{'data_array': [C,D,H,W], 'origin',
'spacing', 'direction'}``; ``save_nd_array_as_image`` writes a 3D array with
metadata copied from a reference image. ``spacing`` is reported as (z, y, x)
exactly like the reference's loader. Trimmed to the volume formats
(NIfTI, MetaImage) the test stage reads and writes.
"""
from __future__ import annotations

import numpy as np

from fpl_plus_torch.io.nifti import (ImageGeometry, NiftiImage, read_image,
                                     write_image)

_VOLUME_EXT = ('.nii.gz', '.nii', '.mha')


def load_nifty_volume_as_4d_array(filename: str) -> dict:
    img = read_image(filename)
    data = img.data
    if data.ndim == 4:
        assert data.shape[3] == 1
        data = data[..., 0]
    if data.ndim == 3:
        data = data[None]
    elif data.ndim != 4:
        raise ValueError('unsupported image dim: {0}'.format(data.ndim))
    sx, sy, sz = (list(img.geometry.spacing) + [1.0, 1.0, 1.0])[:3]
    return {
        'data_array': data,
        'origin': tuple(img.geometry.origin),
        'spacing': (sz, sy, sx),
        'direction': tuple(img.geometry.direction),
    }


def load_image_as_nd_array(image_name: str) -> dict:
    if image_name.endswith(_VOLUME_EXT):
        return load_nifty_volume_as_4d_array(image_name)
    raise ValueError('unsupported image format: {0}'.format(image_name))


def save_array_as_nifty_volume(data: np.ndarray, image_name: str,
                               reference_name: str = None) -> None:
    geom = ImageGeometry()
    if reference_name is not None:
        geom = read_image(reference_name).geometry
    write_image(NiftiImage(data=np.asarray(data), geometry=geom), image_name)


def save_nd_array_as_image(data: np.ndarray, image_name: str,
                           reference_name: str = None) -> None:
    if not image_name.endswith(_VOLUME_EXT) or data.ndim != 3:
        raise ValueError('the test stage writes 3D volumes (.nii.gz, .nii, '
                         '.mha), got {0} for {1}'.format(data.shape,
                                                         image_name))
    save_array_as_nifty_volume(data, image_name, reference_name)
