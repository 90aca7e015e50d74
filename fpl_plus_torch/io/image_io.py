"""High-level volume loading/saving on the sample-dict contract.

API parity with the reference loader
(PyMIC/pymic/io/image_read_write.py:69-148):
``load_image_as_nd_array`` returns ``{'data_array': [C,D,H,W], 'origin',
'spacing', 'direction'}``; ``save_nd_array_as_image`` writes a 3D array with
metadata copied from a reference image. ``spacing`` is reported as (z, y, x)
exactly like the reference's loader. Volumes (NIfTI, MetaImage) and the 2D
images of the classification task (PNG, JPEG, TIFF, through PIL, which is
imported inside the two functions that use it); a ``.npy`` loads as the
pseudo-label bundle ``NiftyDatasetNpy`` reads. ``rotate_nifty_volume_to_lps``
flips a negated axis-aligned volume into LPS.
"""
from __future__ import annotations

import numpy as np

from fpl_plus_torch.io.nifti import (ImageGeometry, NiftiImage, read_image,
                                     write_image)

_VOLUME_EXT = ('.nii.gz', '.nii', '.mha')
_RGB_EXT = ('.jpg', '.jpeg', '.tif', '.png')


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


def load_rgb_image_as_3d_array(filename: str) -> dict:
    """A 2D image as ``[C, H, W]`` (grey: C = 1; RGB(A): its 3 colours)."""
    from PIL import Image
    image = np.asarray(Image.open(filename))
    if image.ndim == 2:
        image = image[None]
    elif image.shape[2] in (3, 4):
        image = np.transpose(image[:, :, :3], (2, 0, 1))
    else:
        raise ValueError('{0}: {1} colour channels'.format(
            filename, image.shape[2]))
    return {'data_array': image, 'origin': (0, 0), 'spacing': (1.0, 1.0),
            'direction': 0}


def load_image_as_nd_array(image_name: str) -> dict:
    if image_name.endswith(_VOLUME_EXT):
        return load_nifty_volume_as_4d_array(image_name)
    if image_name.endswith(_RGB_EXT):
        return load_rgb_image_as_3d_array(image_name)
    if image_name.endswith('.npy'):
        # pseudo-label bundles: a dict with predict / pixel_wise_weight /
        # sample_wise_weight (reference nifty_dataset.py:262-272)
        return np.load(image_name, allow_pickle=True)
    raise ValueError('unsupported image format: {0}'.format(image_name))


def save_array_as_nifty_volume(data: np.ndarray, image_name: str,
                               reference_name: str = None) -> None:
    geom = ImageGeometry()
    if reference_name is not None:
        geom = read_image(reference_name).geometry
    write_image(NiftiImage(data=np.asarray(data), geometry=geom), image_name)


def save_array_as_rgb_image(data: np.ndarray, image_name: str) -> None:
    """A 2D array, or a 3-colour ``[3, H, W]`` / ``[H, W, 3]`` one, as an
    image file."""
    from PIL import Image
    if data.ndim == 3:
        if 3 not in (data.shape[0], data.shape[2]):
            raise ValueError('an image has 3 colours, got {0}'.format(
                data.shape))
        if data.shape[0] == 3:
            data = np.transpose(data, (1, 2, 0))
    Image.fromarray(data).save(image_name)


def save_nd_array_as_image(data: np.ndarray, image_name: str,
                           reference_name: str = None) -> None:
    """A 3D volume (.nii.gz, .nii, .mha) with the reference's metadata, or
    a 2D array as an image (.png, .jpg, .jpeg, .tif)."""
    if image_name.endswith(_VOLUME_EXT) and data.ndim == 3:
        save_array_as_nifty_volume(data, image_name, reference_name)
    elif image_name.endswith(_RGB_EXT) and data.ndim == 2:
        save_array_as_rgb_image(data, image_name)
    else:
        raise ValueError('unsupported array {0} for {1}: 3D volumes go to '
                         '.nii.gz, .nii, .mha and 2D arrays to .png, .jpg, '
                         '.jpeg, .tif'.format(data.shape, image_name))


def rotate_nifty_volume_to_lps(image_dict: dict) -> dict:
    """Flip a volume into LPS orientation when its direction is axis-aligned
    but negated (reference image_read_write.py:151-203): each world axis
    whose direction cosine is negative flips its array axis (x the last, z
    the first spatial one) and negates its direction column. A dict without
    a 3x3 direction comes back as it is."""
    direction = np.asarray(image_dict['direction'], dtype=np.float64)
    if direction.size != 9:
        return image_dict
    direction = direction.reshape(3, 3)
    flips = []
    new_dir = direction.copy()
    # data_array is [C, D, H, W]: world x <-> W (axis 3), y <-> H, z <-> D
    for world_axis, arr_axis in ((0, 3), (1, 2), (2, 1)):
        if direction[world_axis, world_axis] < 0:
            flips.append(arr_axis)
            new_dir[:, world_axis] *= -1
    if flips:
        image_dict = dict(image_dict)
        image_dict['data_array'] = np.flip(image_dict['data_array'],
                                           flips).copy()
        image_dict['direction'] = tuple(new_dir.reshape(-1))
    return image_dict
