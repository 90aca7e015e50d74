"""Segmentation agent: the FPL+ test stages (pseudo labels and the FPL
uncertainty pass).

Parity with the reference SegmentationAgent inference
(PyMIC/pymic/net_run_dsbn/agent_seg.py:834-1083) and the JAX package's
``SegmentationAgent.infer`` (``agents/agent_seg.py:806-1063`` there): load
the checkpoint, run sliding-window + flip-TTA inference on the configured
domain's DSBN bank, undo the test transforms and save label NIfTIs with the
source geometry.

* The save path is the device-label one: softmax is monotonic, so the
  argmax of the logits runs on the device and a uint8 label map crosses
  back; the test chain's inverse transforms compose into one crop of that
  map (``_selection_margins``). ``post_process`` then runs on the host.
* ``test_batch_size > 1``: the loader batch runs as one batched sliding
  window (``Inferer.run_batch``) when neither ``fpl`` nor
  ``test_time_dropout`` is set.
* ``fpl = True``: per volume, 6 MC-dropout passes fold into one batched
  inference and reduce on the device to ``(vars_sum, boundary)``; the
  volume's uncertainty is ``1 if boundary < 50 else vars_sum / boundary``.
  The stage writes no labels; it saves ``fpl_uncertainty_sorted``, the
  ascending ``(uncertainty, name)`` pairs, for ``python -m
  fpl_plus_torch.fpl image-weight``.
* ``test_time_dropout = True``: one dropout pass on the label path.

Dropout randomness: volume i of the stage draws its pass seeds from
``np.random.SeedSequence([random_seed, i])`` and gets one
``torch.Generator`` on the device per pass. The masks therefore differ from
the JAX package's (threefry keys split from ``random_seed``), and on the
card from the CPU's: the two agree in distribution, not in value.

Not ported: an inverse transform that is not a crop (the JAX package's host
path) raises ``NotImplementedError``, as do checkpoint ensembles
(ckpt_mode 3).
"""
from __future__ import annotations

import functools
import logging
import os
import time
from typing import Dict, List

import numpy as np
import torch

from fpl_plus_torch.agents.agent_abstract import NetRunAgent
from fpl_plus_torch.engine import ckpt as ckpt_lib
from fpl_plus_torch.engine.infer import Inferer
from fpl_plus_torch.io.image_io import save_nd_array_as_image
from fpl_plus_torch.io.loader import prefetch_iter
from fpl_plus_torch.models.registry import create_network, param_count
from fpl_plus_torch.utils.image_process import convert_label
from fpl_plus_torch.utils.post_process import PostProcessDict
from fpl_plus_torch.utils.precision import cast_infer_module

FPL_PASSES = 6


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


def _name_of(data) -> str:
    name = data['names'][0]
    return name[0] if isinstance(name, (list, tuple)) else name


def _crop(label: np.ndarray, margins) -> np.ndarray:
    """Crop the spatial axes of ``label [N, *img]`` by ``(lo, up)``."""
    lo, up = margins
    return label[(slice(None),) + tuple(
        slice(a, s - b) for a, b, s in zip(lo, up, label.shape[1:]))]


class SegmentationAgent(NetRunAgent):
    def __init__(self, config: dict, stage: str, device: torch.device):
        super().__init__(config, stage, device)
        self.module = None
        self.postprocessor = None
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

    def _generators(self, volume_index: int, n: int) -> List[torch.Generator]:
        """``n`` dropout generators on the device for the stage's volume
        ``volume_index``, seeded from ``random_seed`` and that index."""
        seeds = np.random.SeedSequence(
            [int(self.random_seed), volume_index]).generate_state(n)
        return [torch.Generator(self.device).manual_seed(int(s))
                for s in seeds]

    def _margins_or_raise(self, data, dim):
        margins = self._selection_margins(data, dim)
        if margins is None:
            raise NotImplementedError(
                'an inverse transform that is not a crop is not yet ported')
        return margins

    def infer(self):
        cfg_test = self.config['testing']
        domain_label = cfg_test.get('domian_label', 0)   # (sic) reference key
        fpl = cfg_test.get('fpl', False)
        tt_dropout = cfg_test.get('test_time_dropout', False) or fpl

        ckpt_name = ckpt_lib.get_checkpoint_name(self.config)
        loaded = ckpt_lib.load_checkpoint(ckpt_name)
        self.module.load_state_dict(loaded['model_state_dict'], strict=True)
        module = cast_infer_module(self.module.to(self.device).eval(),
                                   self.infer_precision)
        logging.info('loaded checkpoint %s (iteration %d)', ckpt_name,
                     int(loaded['iteration']))
        postpro_name = cfg_test.get('post_process', None)
        if self.postprocessor is None and postpro_name is not None:
            self.postprocessor = PostProcessDict[postpro_name](cfg_test)

        # the label head serves the label paths; the FPL pass reduces the
        # logits before any head
        inferer = Inferer(dict(cfg_test, output_mode='label'), self.device)
        predictor = functools.partial(module, domain_label=domain_label)
        infer_times, uncertainty = [], {}
        volume_index = 0
        for batch_data in prefetch_iter(self.test_loader):
            samples = list(_split_batch(batch_data))
            if len(samples) > 1 and not tt_dropout:
                # batched serving: a collated batch is same-shape, so its
                # volumes share one sliding window
                images = np.asarray(batch_data['image'], np.float32)
                margins = [self._margins_or_raise(d, images.ndim - 2)
                           for d in samples]
                t0 = time.time()
                labels = inferer.run_batch(predictor, images)
                dt = (time.time() - t0) / len(samples)
                for i, (data, m) in enumerate(zip(samples, margins)):
                    data['predict_label'] = _crop(labels[i:i + 1], m)
                    self.save_outputs(data)
                infer_times.extend([dt] * len(samples))
                volume_index += len(samples)
                continue
            for data in samples:
                images = np.asarray(data['image'], np.float32)
                margins = self._margins_or_raise(data, images.ndim - 2)
                t0 = time.time()
                if fpl:
                    vars_, boundary = inferer.run_fpl_uncertainty(
                        functools.partial(
                            predictor, dropout_generators=self._generators(
                                volume_index, FPL_PASSES)),
                        images, FPL_PASSES, margins)
                    uncer_one = 1 if boundary < 50 else vars_ / boundary
                    name = _name_of(data)
                    uncertainty[name] = [uncer_one]
                    logging.info('%s %s', name, uncer_one)
                else:
                    pred = predictor
                    if tt_dropout:
                        pred = functools.partial(
                            predictor, dropout_generators=self._generators(
                                volume_index, 1))
                    data['predict_label'] = _crop(
                        inferer.run(pred, images), margins)
                    self.save_outputs(data)
                infer_times.append(time.time() - t0)
                volume_index += 1
        if fpl:
            pairs = sorted(zip(uncertainty.values(), uncertainty.keys()))
            np.save(cfg_test['fpl_uncertainty_sorted'],
                    np.asarray(pairs, dtype=object))
            logging.info('FPL uncertainty list saved (%d volumes)',
                         len(pairs))
        if infer_times:
            arr = np.asarray(infer_times)
            logging.info('testing time %s +/- %s', arr.mean(), arr.std())

    def save_outputs(self, data: Dict):
        """Label convert -> post-process -> save NIfTI with metadata from
        the source image (reference :1022-1083), into
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
        if self.postprocessor is not None:
            for i in range(output.shape[0]):
                output[i] = self.postprocessor(output[i])
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
