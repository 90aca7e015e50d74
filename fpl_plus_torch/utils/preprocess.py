"""Offline transform application (reference PyMIC/pymic/util/preprocess.py:
8-55, the JAX package's ``utils/preprocess.py``): build a transform chain
from a config file and run it over an image (and its label), writing the
transformed volumes as NIfTI with the sample's geometry. Host only.

    python -m fpl_plus_torch.utils.preprocess chain.cfg in.nii.gz \\
        out.nii.gz [--label-in lab.nii.gz --label-out lab_out.nii.gz]

The cfg's ``[dataset] transform = [...]`` names the chain; the transforms'
parameters sit in the same section, as in a training cfg.
"""
from __future__ import annotations

import numpy as np

from fpl_plus_torch.config.parser import parse_config
from fpl_plus_torch.io.image_io import load_image_as_nd_array
from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_image
from fpl_plus_torch.transforms.trans_dict import build_transforms


def get_transform_list(trans_config_file: str):
    """The transforms ``[dataset] transform`` of the cfg names, built from
    the section's parameters."""
    params = parse_config(trans_config_file)['dataset']
    params['task'] = 'segmentation'
    return build_transforms(params['transform'], params)[0]


def preprocess_with_transform(transforms, img_in_name: str,
                              img_out_name: str, lab_in_name=None,
                              lab_out_name=None) -> None:
    """Apply ``transforms`` to the image (and label) and write channel 0 of
    each with the transformed sample's origin, spacing and direction."""
    image_dict = load_image_as_nd_array(img_in_name)
    sample = {'image': np.asarray(image_dict['data_array'], np.float32),
              'origin': image_dict['origin'],
              'spacing': image_dict['spacing'],
              'direction': image_dict['direction']}
    if lab_in_name is not None:
        sample['label'] = load_image_as_nd_array(lab_in_name)['data_array']
    for transform in transforms:
        sample = transform(sample)

    sz, sy, sx = sample['spacing']
    geom = ImageGeometry(origin=tuple(sample['origin']),
                         spacing=(sx, sy, sz),
                         direction=tuple(sample['direction'])
                         if np.size(sample['direction']) == 9
                         else (1, 0, 0, 0, 1, 0, 0, 0, 1))
    write_image(NiftiImage(np.asarray(sample['image'][0]), geom),
                img_out_name)
    if lab_in_name is not None and lab_out_name is not None:
        write_image(NiftiImage(np.asarray(sample['label'][0]), geom),
                    lab_out_name)


def main(argv=None):
    """CLI for the reference's hardcoded-path ``__main__`` block
    (util/preprocess.py:43-55)."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(prog='python -m '
                                      'fpl_plus_torch.utils.preprocess')
    ap.add_argument('transform_cfg', help='cfg with [dataset] transform = '
                                          '[...] and the transforms\' '
                                          'parameters')
    ap.add_argument('image_in')
    ap.add_argument('image_out')
    ap.add_argument('--label-in')
    ap.add_argument('--label-out')
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    preprocess_with_transform(get_transform_list(args.transform_cfg),
                              args.image_in, args.image_out, args.label_in,
                              args.label_out)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
