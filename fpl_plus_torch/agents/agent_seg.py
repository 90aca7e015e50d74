"""Segmentation agent: the FPL+ pseudo-label test stage.

Parity with the reference SegmentationAgent inference
(PyMIC/pymic/net_run_dsbn/agent_seg.py:834-1083): load the checkpoint, run
sliding-window + flip-TTA inference on the configured domain's DSBN bank,
undo the test transforms and save label NIfTIs with the source geometry.

The save path is the device-label one: softmax is monotonic, so the argmax
of the logits runs on the device and a uint8 label map crosses back; the
test chain's inverse transforms compose into one crop of that map
(``_selection_margins``). ``test_batch_size > 1`` runs volume by volume,
which gives the same voxels as a batched program. The FPL uncertainty pass
(``fpl``), ``test_time_dropout``, ``post_process`` and checkpoint ensembles
are later slices (ROADMAP.md).
"""
from __future__ import annotations

import functools
import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from fpl_plus_torch.agents.agent_abstract import NetRunAgent
from fpl_plus_torch.engine import ckpt as ckpt_lib
from fpl_plus_torch.engine.infer import Inferer
from fpl_plus_torch.io.image_io import save_nd_array_as_image
from fpl_plus_torch.models.registry import create_network, param_count
from fpl_plus_torch.utils.image_process import convert_label
from fpl_plus_torch.utils.precision import cast_infer_module


def _split_batch(batch):
    """Yield per-sample dicts (batch dim kept at 1) from a collated batch —
    the Inferer and the inverse-transform bookkeeping are per-volume."""
    n = batch['image'].shape[0]
    if n == 1:
        yield batch
        return
    for i in range(n):
        item = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.ndim > 0 and v.shape[0] == n:
                item[k] = v[i:i + 1]
            elif isinstance(v, (list, tuple)) and len(v) == n:
                item[k] = [v[i]]
            else:
                item[k] = v
        yield item


class SegmentationAgent(NetRunAgent):
    def __init__(self, config: dict, stage: str, device: torch.device):
        super().__init__(config, stage, device)
        self.module = None
        self.infer_precision = config['testing'].get('precision', 'float32')

    def create_network(self):
        if self.module is None:
            self.module = create_network(self.config['network'])
        logging.info('parameter number %d', param_count(self.module))

    def _selection_margins(self, data, dim):
        """Compose the test chain's inverse transforms into one spatial
        selection ``(margin_lower, margin_upper)`` when every active inverse
        is a pure crop (the production chain is [NormalizeWithMeanStd, Pad],
        whose only inverse, Pad's, crops); None otherwise. Successive crops
        compose by adding margins."""
        lo = [0] * dim
        up = [0] * dim
        for transform in self.transform_list[::-1]:
            if not transform.inverse:
                continue
            sel = transform.inverse_selection(data)
            if sel is None:
                return None
            ml, mu = sel
            lo = [a + int(b) for a, b in zip(lo, ml)]
            up = [a + int(b) for a, b in zip(up, mu)]
        return lo, up

    def _label_inferer(self) -> Inferer:
        infer_cfg = dict(self.config['testing'])
        infer_cfg['output_mode'] = 'label'
        return Inferer(infer_cfg, self.device)

    def infer(self):
        cfg_test = self.config['testing']
        for key in ('fpl', 'test_time_dropout'):
            if cfg_test.get(key, False):
                raise NotImplementedError(
                    '[testing] {0} is not yet ported (FPL uncertainty '
                    'slice, ROADMAP.md)'.format(key))
        if cfg_test.get('post_process', None) is not None:
            raise NotImplementedError('[testing] post_process is not yet '
                                      'ported')
        domain_label = cfg_test.get('domian_label', 0)   # (sic) reference key

        ckpt_name = ckpt_lib.get_checkpoint_name(self.config)
        loaded = ckpt_lib.load_checkpoint(ckpt_name)
        self.module.load_state_dict(loaded['model_state_dict'], strict=True)
        module = cast_infer_module(self.module.to(self.device).eval(),
                                   self.infer_precision)
        logging.info('loaded checkpoint %s (iteration %d)', ckpt_name,
                     int(loaded['iteration']))

        inferer = self._label_inferer()
        predictor = functools.partial(module, domain_label=domain_label)
        infer_times = []
        for batch_data in self.test_loader:
            for data in _split_batch(batch_data):
                images = np.asarray(data['image'], np.float32)
                margins = self._selection_margins(data, images.ndim - 2)
                if margins is None:
                    raise NotImplementedError(
                        'an inverse transform that is not a crop is not '
                        'yet ported')
                t0 = time.time()
                label = inferer.run(predictor, images)      # [1, *img] u8
                lo, up = margins
                data['predict_label'] = label[(slice(None),) + tuple(
                    slice(l, s - u) for l, u, s in
                    zip(lo, up, label.shape[1:]))]
                infer_times.append(time.time() - t0)
                self.save_outputs(data)
        if infer_times:
            arr = np.asarray(infer_times)
            logging.info('testing time %s +/- %s', arr.mean(), arr.std())

    def save_outputs(self, data: Dict):
        """Label convert -> save NIfTI with metadata from the source image
        (reference :1022-1083), into
        ``output_dir/(ckpt_dir + '_' + test_csv_stem)``."""
        cfg_test = self.config['testing']
        output_dir = cfg_test['output_dir']
        ignore_dir = cfg_test.get('filename_ignore_dir', True)
        label_source = cfg_test.get('label_source', None)
        label_target = cfg_test.get('label_target', None)
        fname_src = cfg_test.get('filename_replace_source', None)
        fname_tgt = cfg_test.get('filename_replace_target', None)
        ckpt_dir = self.config['training']['ckpt_save_dir'].split('/')[-1]
        subset = self.config['dataset']['test_csv'].split('/')[-1][:-4]
        output_dir = os.path.join(output_dir, ckpt_dir + '_' + subset)
        os.makedirs(output_dir, exist_ok=True)

        names = data['names']
        output = np.asarray(data['predict_label'], np.uint8)
        if label_source is not None and label_target is not None:
            output = convert_label(output, label_source, label_target)
        root_dir = self.config['dataset']['root_dir']
        for i in range(output.shape[0]):
            name = names[i]
            if isinstance(name, (list, tuple)):
                name = name[0]
            save_name = name.split('/')[-1] if ignore_dir else \
                name.replace('/', '_')
            if fname_src is not None and fname_tgt is not None:
                save_name = save_name.replace(fname_src, fname_tgt)
            save_path = '{0}/{1}'.format(output_dir, save_name)
            save_nd_array_as_image(output[i], save_path,
                                   root_dir + '/' + name)
