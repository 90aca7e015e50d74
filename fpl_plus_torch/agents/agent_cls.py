"""Classification agent (reference PyMIC/pymic/net_run/agent_cls.py:22-349,
the JAX package's ``agents/agent_cls.py``).

Tasks ``cls`` (softmax, argmax) and ``cls_nexcl`` (sigmoid, threshold
0.5). ``cls`` trains on the ``label`` column; ``cls_nexcl`` on the
``[N, C]`` 0/1 rows ``label_prob`` that the chain's ``LabelToProbability``
makes, as the reference's agent does (the JAX package hands the ``[N]``
labels to the sigmoid loss and the score, whose shapes do not broadcast
against ``[N, C]`` logits).

Training runs in blocks of ``iter_valid`` iterations: one train-mode
forward, loss and optimizer update per iteration (``[training] precision
= bfloat16`` or ``float16``: copies of the f32 parameters and of the input
in that dtype feed the forward, as in ``engine/train.py``), then
validation over the valid manifest (the ``evaluation_metric``, default
accuracy), the plateau controller, a ``.pt`` checkpoint per block and the
best one with its pointer; ``iter_start > 0`` resumes from ``{prefix}_{iter_start}.pt`` with
its optimizer state. The dropout of iteration ``it`` draws from a
``torch.Generator`` seeded from ``SeedSequence([random_seed, it])``.
Inference writes ``output_csv`` (``image,label``, or ``image,label0,..``
for ``cls_nexcl``) and, with ``save_probability``, ``*_prob.csv``.

``[network] pretrain = True`` loads the torchvision ``.pth`` at
``pretrained_path`` into the backbone (the head, and the first
convolution when ``input_chns != 3``, stay fresh); without a path it warns
and keeps the random weights: nothing is downloaded.

The network comes from ``net_dict`` (default ``TorchClsNetDict``) and the
loss from ``loss_dict`` (default ``ClsLossDict``), both replaceable
through ``set_network_dict`` / ``set_loss_dict``, as in the JAX package
(``agents/agent_cls.py:36-37,60-62``); a module assigned before
``create_network`` is kept.
"""
from __future__ import annotations

import csv
import logging
import time

import numpy as np
import torch
from torch.func import functional_call

from fpl_plus_torch.agents.agent_abstract import NetRunAgent
from fpl_plus_torch.engine import ckpt as ckpt_lib
from fpl_plus_torch.engine.optim import PlateauScheduler, create_optimizer
from fpl_plus_torch.io.dataset import ClassificationDataset
from fpl_plus_torch.io.loader import repeat_loader
from fpl_plus_torch.losses.cls import ClsLossDict
from fpl_plus_torch.models.cls_nets import TorchClsNetDict, load_pretrained
from fpl_plus_torch.models.registry import param_count
from fpl_plus_torch.utils.precision import cast_infer_module, resolve_dtype
from fpl_plus_torch.utils.scalar_writer import ScalarWriter


def _images(data, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        data['image'], np.float32)).to(device)


class ClassificationAgent(NetRunAgent):
    def __init__(self, config: dict, stage: str, device):
        super().__init__(config, stage, device)
        self.loss_dict = ClsLossDict
        self.net_dict = TorchClsNetDict
        self.module = None
        self.task = config['dataset'].get('task_type', 'cls')
        self.train_dtype = resolve_dtype(
            config.get('training', {}).get('precision', 'float32'))

    def task_type(self) -> str:
        return 'classification'

    def get_stage_dataset_from_config(self, stage: str
                                      ) -> ClassificationDataset:
        data_cfg = self.config['dataset']
        real_stage = stage.split('_')[-1]
        csv_file = data_cfg.get(stage + '_csv', None) or data_cfg.get(
            real_stage + '_csv', None)
        return ClassificationDataset(
            root_dir=data_cfg['root_dir'], csv_file=csv_file,
            modal_num=data_cfg.get('modal_num', 1),
            class_num=self.config['network']['class_num'],
            with_label=real_stage != 'test',
            transform=self.build_transform(real_stage))

    def create_network(self):
        net_cfg = self.config['network']
        net_name = net_cfg['net_type']
        if self.module is None:
            if net_name not in self.net_dict:
                raise ValueError('Undefined network {0}'.format(net_name))
            self.module = self.net_dict[net_name](net_cfg)
            if net_cfg.get('pretrain', False):
                path = net_cfg.get('pretrained_path', None)
                if path:
                    n = load_pretrained(self.module, net_name, path,
                                        net_cfg.get('input_chns', 3))
                    logging.info('loaded %d pretrained tensors from %s', n,
                                 path)
                else:
                    logging.warning(
                        'pretrain = True but no [network] pretrained_path; '
                        'random weights kept (nothing is downloaded)')
        logging.info('parameter number %d', param_count(self.module))

    def _loss_calculator(self):
        loss_name = self.config['training'].get('loss_type',
                                                'CrossEntropyLoss')
        if loss_name not in self.loss_dict:
            raise ValueError('Undefined loss function {0}'.format(loss_name))
        return self.loss_dict[loss_name](self.config['training'])

    def _targets(self, data) -> np.ndarray:
        """The ground truth of a batch: ``label`` [N] (cls) or
        ``label_prob`` [N, C] (cls_nexcl)."""
        if self.task == 'cls':
            return np.asarray(data['label'])
        if data.get('label_prob', None) is None:
            raise ValueError('cls_nexcl trains on label_prob: add '
                             'LabelToProbability to the transform chains')
        return np.asarray(data['label_prob'], np.float32)

    def _score(self, logits: np.ndarray, labels: np.ndarray) -> float:
        if self.task == 'cls':
            return float(np.mean(np.argmax(logits, axis=1) == labels))
        preds = (1 / (1 + np.exp(-logits))) > 0.5
        return float(np.mean(preds == labels))

    def _forward(self, x, generators=None):
        """The train-mode forward (bf16 or f16 copies under ``precision
        = bfloat16`` or ``float16``), f32 logits."""
        if self.train_dtype is None:
            return self.module(x, generators)
        params = {k: p.to(self.train_dtype)
                  for k, p in self.module.named_parameters()}
        return functional_call(self.module, params,
                               (x.to(self.train_dtype), generators)).float()

    def _generators(self, iteration: int):
        seed = np.random.SeedSequence([int(self.random_seed), iteration]
                                      ).generate_state(1)[0]
        return [torch.Generator(self.device).manual_seed(int(seed))]

    def train_step(self, optimizer, loss_calc, x, labels, iteration):
        """One update; returns the detached loss and logits."""
        out = self._forward(x, self._generators(iteration))
        loss = loss_calc({'prediction': out, 'ground_truth': labels})
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
        optimizer.step()
        return loss.detach(), out.detach()

    @torch.no_grad()
    def _validate(self, loss_calc):
        self.module.eval()
        try:
            loss_sum, score_sum, n = 0.0, 0.0, 0
            for data in self.valid_loaders[0]:
                labels = self._targets(data)
                out = self.module(_images(data, self.device)).float()
                loss = loss_calc({'prediction': out, 'ground_truth':
                                  torch.as_tensor(labels, device=out.device)})
                bn = labels.shape[0]
                n += bn
                loss_sum += float(loss) * bn
                score_sum += self._score(out.cpu().numpy(), labels) * bn
        finally:
            self.module.train()
        return loss_sum / n, score_sum / n

    def train_valid(self):
        cfg_t = self.config['training']
        ckpt_dir = cfg_t['ckpt_save_dir']
        prefix = ckpt_lib.ckpt_prefix_of(self.config)
        iter_start = cfg_t.get('iter_start', 0)
        iter_max = cfg_t['iter_max']
        iter_valid = cfg_t['iter_valid']
        metric = cfg_t.get('evaluation_metric', 'accuracy')
        module = self.module.to(self.device)
        opt_state = None
        if iter_start > 0:
            path = ckpt_lib.checkpoint_path(ckpt_dir, prefix, iter_start)
            loaded = ckpt_lib.load_checkpoint(path)
            module.load_state_dict(loaded['model_state_dict'])
            opt_state = loaded.get('optimizer_state_dict', None)
            logging.info('resumed from %s', path)
        optimizer = create_optimizer(cfg_t, module.parameters())
        if opt_state is not None:
            optimizer.load_state_dict(opt_state)
        plateau = PlateauScheduler(dict(cfg_t, iter_valid=iter_valid))
        loss_calc = self._loss_calculator()
        writer = ScalarWriter(ckpt_dir)
        ckpt_writer = ckpt_lib.CheckpointWriter()
        train_iter = repeat_loader(self.train_loaders[0])
        max_score, max_it, best_state = -1.0, iter_start, None
        module.train()
        try:
            for block in range(iter_start, iter_max, iter_valid):
                loss_sum, score_sum, n = 0.0, 0.0, 0
                t0 = time.time()
                for sub_it in range(iter_valid):
                    data = next(train_iter)
                    labels = self._targets(data)
                    loss, out = self.train_step(
                        optimizer, loss_calc, _images(data, self.device),
                        torch.as_tensor(labels, device=self.device),
                        block + sub_it)
                    bn = labels.shape[0]
                    n += bn
                    loss_sum += float(loss) * bn
                    score_sum += self._score(out.cpu().numpy(), labels) * bn
                t1 = time.time()
                v_loss, v_score = self._validate(loss_calc)
                glob_it = block + iter_valid
                writer.add_scalars('loss', {'train': loss_sum / n,
                                            'valid': v_loss}, glob_it)
                writer.add_scalars(metric, {'train': score_sum / n,
                                            'valid': v_score}, glob_it)
                logging.info('it %d train loss %.4f %s %.4f | valid loss '
                             '%.4f %s %.4f; training/validation time '
                             '%.2fs/%.2fs', glob_it, loss_sum / n, metric,
                             score_sum / n, v_loss, metric, v_score, t1 - t0,
                             time.time() - t1)
                if plateau.enabled:
                    scale = plateau.step(v_score)
                    for group in optimizer.param_groups:
                        group['lr'] = cfg_t['learning_rate'] * scale
                if v_score > max_score:
                    max_score, max_it = v_score, glob_it
                    best_state = ckpt_lib.snapshot(module.state_dict())
                ckpt_writer.submit(ckpt_dir, prefix, glob_it, {
                    'model_state_dict': module.state_dict(),
                    'optimizer_state_dict': optimizer.state_dict()}, v_score)
            if best_state is not None:
                ckpt_writer.submit(ckpt_dir, prefix, max_it, {
                    'model_state_dict': best_state,
                    'optimizer_state_dict': optimizer.state_dict()},
                    max_score, update_latest=False)
            ckpt_writer.close()   # artifacts durable before the pointer
        finally:
            writer.close()
            try:
                ckpt_writer.close()   # no-op on the success path
            except Exception:
                logging.exception('checkpoint writer close failed during '
                                  'unwind')
        ckpt_lib.write_best_pointer(ckpt_dir, prefix, max_it)
        logging.info('The best performing iter is %d, valid %s %s', max_it,
                     metric, max_score)

    @torch.no_grad()
    def infer(self):
        cfg_test = self.config['testing']
        ckpt_name = ckpt_lib.get_checkpoint_name(self.config)
        loaded = ckpt_lib.load_checkpoint(ckpt_name)
        self.module.load_state_dict(loaded['model_state_dict'])
        module = cast_infer_module(self.module.to(self.device).eval(),
                                   cfg_test.get('precision', 'float32'))
        dtype = next(module.parameters()).dtype
        output_csv = cfg_test['output_csv']
        class_num = self.config['network']['class_num']
        out_lab_list, out_prob_list, times = [], [], []
        for data in self.test_loader:
            t0 = time.time()
            logits = module(_images(data, self.device).to(dtype)).float()
            logits = logits.cpu().numpy()
            times.append(time.time() - t0)
            if self.task == 'cls':
                e = np.exp(logits - logits.max(axis=1, keepdims=True))
                prob = e / e.sum(axis=1, keepdims=True)
                lab = np.argmax(prob, axis=1)
            else:
                prob = 1 / (1 + np.exp(-logits))
                lab = np.asarray(prob > 0.5, np.uint8)
            for i, name in enumerate(data['names']):
                out_lab_list.append([name] + ([lab[i]] if self.task == 'cls'
                                              else lab[i].tolist()))
                out_prob_list.append([name] + prob[i].tolist())
        with open(output_csv, 'w', newline='') as f:
            writer = csv.writer(f, delimiter=',', quotechar='"',
                                quoting=csv.QUOTE_MINIMAL)
            writer.writerow(['image', 'label'] if len(out_lab_list[0]) == 2
                            else ['image'] + ['label{0}'.format(i)
                                              for i in range(class_num)])
            writer.writerows(out_lab_list)
        if cfg_test.get('save_probability', False):
            with open(output_csv.replace('.csv', '_prob.csv'), 'w',
                      newline='') as f:
                writer = csv.writer(f, delimiter=',', quotechar='"',
                                    quoting=csv.QUOTE_MINIMAL)
                writer.writerow(['image'] + ['prob{0}'.format(i)
                                             for i in range(class_num)])
                writer.writerows(out_prob_list)
        arr = np.asarray(times)
        logging.info('testing time %s +/- %s', arr.mean(), arr.std())
