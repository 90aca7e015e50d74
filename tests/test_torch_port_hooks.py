"""PyTorch port, the agents' customization hooks against the JAX package's
(``agents/agent_abstract.py:84-100``, ``transforms/trans_dict.py:63``,
``transforms/abstract.py:16``, ``losses/__init__.py:32``).

* ``build_transforms`` and ``SPATIAL_KEYS``: the same chain of class names
  as JAX's; a deterministic chain gives equal arrays on a seeded sample; an
  unknown name raises ``ValueError`` in both.
* A transform registry and a loss registry of the caller's, injected into
  both packages' segmentation agents: the same chain (equal arrays) and
  the same loss value on one seeded batch (rtol 1e-5; host transforms and
  a few eager ops on tiny arrays, no network compile on the JAX side).
* A set Inferer is the one that validation and the test stage's logits
  paths (the FPL pass, the host path) call; an injected ``test_set`` is the
  one served; an injected train or valid set raises; the SSL agent's
  unlabelled chain uses the injected registry; the classification agent
  builds its net and loss from injected registries.

The workspace is the dry run's (``fpl_plus_torch.dryrun``) with a tiny
seeded UNet2D5_dsbn checkpoint, on the CPU.
"""
import copy
import os

import numpy as np
import pytest
import torch

from fpl_plus_torch import dryrun
from fpl_plus_torch.agents.agent_cls import ClassificationAgent
from fpl_plus_torch.agents.agent_seg import SegmentationAgent
from fpl_plus_torch.config.parser import parse_config, synchronize_config
from fpl_plus_torch.engine import ckpt as ckpt_lib
from fpl_plus_torch.engine.infer import Inferer
from fpl_plus_torch.io.dataset import NiftyDataset
from fpl_plus_torch.io.image_io import load_image_as_nd_array
from fpl_plus_torch.losses import SegLossDict
from fpl_plus_torch.models.registry import create_network
from fpl_plus_torch.transforms import trans_dict
from fpl_plus_torch.transforms.abstract import SPATIAL_KEYS

CHAIN = ['NormalizeWithMeanStd', 'Pad', 'LabelToProbability']
# the config parser's keys are lower case
PARAMS = {'normalizewithmeanstd_channels': [0],
          'pad_output_size': [8, 16, 16],
          'labeltoprobability_class_num': 2, 'task': 'segmentation'}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny CPU forwards need no thread pool; a full one per test worker
    only contends with the work beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample(seed=0):
    rs = np.random.RandomState(seed)
    return {'image': rs.normal(2.0, 3.0, (1, 6, 12, 20)).astype(np.float32),
            'label': (rs.uniform(size=(1, 6, 12, 20)) > 0.6).astype(
                np.int16),
            'names': ['s.nii.gz']}


def _apply(chain, sample):
    return chain(copy.deepcopy(sample))


def test_build_transforms_matches_jax():
    from fpl_plus_tpu.transforms.abstract import SPATIAL_KEYS as JAX_KEYS
    from fpl_plus_tpu.transforms.trans_dict import build_transforms as jax_bt
    assert SPATIAL_KEYS == JAX_KEYS
    ref_list, ref = jax_bt(CHAIN, dict(PARAMS))
    got_list, got = trans_dict.build_transforms(CHAIN, dict(PARAMS))
    assert [type(t).__name__ for t in got_list] == \
        [type(t).__name__ for t in ref_list] == CHAIN
    assert got.transforms == got_list
    a, b = _apply(ref, _sample()), _apply(got, _sample())
    for key in ('image', 'label', 'label_prob'):
        np.testing.assert_allclose(b[key], a[key], rtol=1e-6, atol=1e-6,
                                   err_msg=key)
    for build in (jax_bt, trans_dict.build_transforms):
        with pytest.raises(ValueError, match='Undefined transform'):
            build(['NoSuchTransform'], dict(PARAMS))


class Shift:
    """A transform of the caller's: ``image + Shift_offset`` (host numpy,
    so one class serves both packages)."""
    inverse = False

    def __init__(self, params):
        self.offset = float(params['shift_offset'])

    def __call__(self, sample):
        sample['image'] = sample['image'] + np.float32(self.offset)
        return sample

    def cache_safe(self):
        return True


@pytest.fixture(scope='module')
def workspace(tmp_path_factory):
    """The dry run's workspace and a seeded tiny checkpoint of its net."""
    root = str(tmp_path_factory.mktemp('torch_port_hooks'))
    dryrun.write_workspace(root)
    torch.manual_seed(11)
    net = create_network(dryrun.DRYRUN_NET)
    ckpt_lib.save_checkpoint(os.path.join(root, 'model', 'dryrun'), 'dryrun',
                             2, {'model_state_dict': net.state_dict()}, 0.0)
    return root


def _config(root, name, jax=False, **kw):
    path = dryrun.write_cfg(root, name, 1, **kw)
    if jax:
        from fpl_plus_tpu.config.parser import parse_config as jax_parse
        from fpl_plus_tpu.config.parser import synchronize_config as jax_sync
        return jax_sync(jax_parse(path))
    return synchronize_config(parse_config(path))


def _edited(root, name, replace):
    """A dry-run config with each ``(old, new)`` of ``replace`` made."""
    path = dryrun.write_cfg(root, name, 1)
    with open(path) as f:
        text = f.read()
    for old, new in replace:
        assert old in text, old
        text = text.replace(old, new)
    with open(path, 'w') as f:
        f.write(text)
    return path


def test_injected_transform_and_loss_dicts_match_jax(workspace):
    from fpl_plus_tpu.agents.agent_seg import (SegmentationAgent as
                                               JaxAgent)
    from fpl_plus_tpu.config.parser import parse_config as jax_parse
    from fpl_plus_tpu.losses import SegLossDict as JaxLossDict
    from fpl_plus_tpu.losses import create_loss_calculator as jax_loss
    from fpl_plus_tpu.transforms.trans_dict import TransformDict as JaxTD
    from fpl_plus_torch.losses import create_loss_calculator
    path = _edited(workspace, 'custom.cfg', [
        ('test_transform = [NormalizeWithMeanStd, Pad]',
         'test_transform = [NormalizeWithMeanStd, Shift, Pad]\n'
         'Shift_offset = 0.5'),
        ('loss_type = DiceLoss', 'loss_type = MyDice')])
    port = SegmentationAgent(synchronize_config(parse_config(path)), 'test',
                             'cpu')
    ref = JaxAgent(jax_parse(path), 'test')
    for agent, registry, losses in ((port, trans_dict.TransformDict,
                                     SegLossDict),
                                    (ref, JaxTD, JaxLossDict)):
        agent.set_transform_dict(dict(registry, Shift=Shift))
        agent.set_loss_dict({'MyDice': losses['DiceLoss']})
    chains = [agent.build_transform('test') for agent in (ref, port)]
    assert [type(t).__name__ for t in chains[1].transforms] == \
        [type(t).__name__ for t in chains[0].transforms] == \
        ['NormalizeWithMeanStd', 'Shift', 'Pad']
    a, b = (_apply(c, _sample(1)) for c in chains)
    np.testing.assert_allclose(b['image'], a['image'], rtol=1e-6, atol=1e-6)
    assert port.transform_list == chains[1].transforms

    rs = np.random.RandomState(2)
    logits = rs.normal(size=(2, 2, 4, 6, 6)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(rs.uniform(size=(2, 4, 6, 6)) > 0.5)
                                    .astype(int)]
    ref_loss = jax_loss(ref.config, ref.loss_dict)
    got_loss = create_loss_calculator(port.config, port.loss_dict)
    assert type(got_loss).__name__ == type(ref_loss).__name__ == 'DiceLoss'
    want = float(ref_loss({'prediction': np.moveaxis(logits, 1, -1),
                           'ground_truth': y}))
    got = float(got_loss({'prediction': torch.from_numpy(logits),
                          'ground_truth': torch.from_numpy(
                              np.moveaxis(y, -1, 1).copy())}))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # without the injected registry the name is unknown in both
    for make, cfg in ((jax_loss, ref.config),
                      (create_loss_calculator, port.config)):
        with pytest.raises(ValueError, match='Undefined loss'):
            make(cfg)


class Recording(Inferer):
    """The port's Inferer, logging which entry each call took."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls = []

    def run_async(self, *args, **kwargs):
        self.calls.append('run_async')
        return super().run_async(*args, **kwargs)

    def run_logits(self, *args, **kwargs):
        self.calls.append('run_logits')
        return super().run_logits(*args, **kwargs)

    def run_passes_async(self, *args, **kwargs):
        self.calls.append('run_passes_async')
        return super().run_passes_async(*args, **kwargs)

    def run_fpl_uncertainty(self, *args, **kwargs):
        self.calls.append('run_fpl_uncertainty')
        return super().run_fpl_uncertainty(*args, **kwargs)


PATHS = {
    'fpl': ({'fpl': 'True', 'extra_testing': (
        'test_time_dropout = True\nfpl_uncertainty_sorted = {root}/fpl.npy')},
        ['run_fpl_uncertainty'] * 2),
    'host': ({'extra_testing': 'infer_device_label = False'},
             ['run_async'] * 2),
}


@pytest.mark.parametrize('path', sorted(PATHS))
def test_set_inferer_is_the_one_the_test_stage_calls(workspace, path):
    kw, want = PATHS[path]
    kw = {k: v.format(root=workspace) for k, v in kw.items()}
    config = _config(workspace, path + '.cfg', **kw)
    config['testing']['output_dir'] = os.path.join(workspace, 'out_' + path)
    agent = SegmentationAgent(config, 'test', 'cpu')
    inferer = Recording(dict(config['testing'], output_mode='logits'), 'cpu')
    agent.set_inferer(inferer)
    agent.run()
    assert agent.inferer is inferer
    assert inferer.calls == want


def test_set_inferer_and_loss_dict_reach_validation(workspace):
    config = _config(workspace, 'train.cfg')
    agent = SegmentationAgent(config, 'train', 'cpu')
    inferer = Recording(dict(config['testing'], output_mode='logits'), 'cpu')
    agent.set_inferer(inferer)

    class Dice(SegLossDict['DiceLoss']):
        pass

    agent.set_loss_dict({'DiceLoss': Dice})
    agent.create_dataset()
    agent.create_network()
    try:
        scores = agent.validation()
    finally:
        agent.shutdown()
    assert inferer.calls == ['run_logits'] * 2       # one valid case each
    assert type(agent._valid_loss) is Dice
    assert np.isfinite(scores['loss'])
    opt = torch.optim.Adam(agent.module.parameters())
    assert type(agent._build_step(opt, None).loss_calculator) is Dice


def test_injected_test_set_is_served(workspace):
    """The fake-source images served through ``set_datasets(test_set=)``
    under a config that names the target set: the labels equal those of
    the config that names the fake-source set."""
    def labels(tag, test_set=None, test_csv='d1_train_img.csv'):
        config = _config(workspace, tag + '.cfg', test_csv=test_csv)
        config['testing']['output_dir'] = os.path.join(workspace, tag)
        agent = SegmentationAgent(config, 'test', 'cpu')
        if test_set is not None:
            agent.set_datasets(test_set=test_set)
        agent.run()
        if test_set is not None:
            assert agent.test_set is test_set
            assert agent.test_loader.dataset is test_set
        out = os.path.join(workspace, tag, 'dryrun_' + test_csv[:-4])
        return {n: load_image_as_nd_array(os.path.join(out, n))['data_array']
                for n in sorted(os.listdir(out)) if n.endswith('.nii.gz')}

    probe = SegmentationAgent(_config(workspace, 'probe.cfg'), 'test', 'cpu')
    fake = NiftyDataset(root_dir=workspace, csv_file=os.path.join(
        workspace, 'd1cyc_train_img.csv'), modal_num=1, with_label=False,
        transform=probe.build_transform('test'))
    got = labels('injected', fake)
    want = labels('configured', test_csv='d1cyc_train_img.csv')
    assert list(got) == list(want) == ['case0.nii.gz', 'case1.nii.gz']
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize('which', ['train_set', 'valid_set'])
def test_injected_train_or_valid_set_raises(workspace, which):
    agent = SegmentationAgent(_config(workspace, 'gen.cfg'), 'train', 'cpu')
    with pytest.raises(NotImplementedError, match='only test_set'):
        agent.set_datasets(**{which: object()})


def test_stage_datasets_come_from_the_config(workspace):
    agent = SegmentationAgent(_config(workspace, 'gen.cfg'), 'train', 'cpu')
    assert not hasattr(agent, 'stage_dataset')
    for stage, n, labelled in (('1_train', 2, True), ('2_valid', 1, True),
                               ('test', 2, False)):
        ds = agent.get_stage_dataset_from_config(stage)
        assert len(ds) == n
        assert ('label' in ds[0]) == labelled, stage
    with pytest.raises(ValueError, match='Undefined dataset stage'):
        agent.get_stage_dataset_from_config('3_train')


def test_ssl_unlabelled_chain_uses_the_injected_registry(workspace):
    from fpl_plus_torch.agents.ssl import SSLMethodDict
    path = _edited(workspace, 'ssl.cfg', [('[network]', (
        'train_csv = {0}/d0_train.csv\n'
        'train_csv_unlab = {0}/d1_train_img.csv\ntrain_batch_size_unlab = 2\n'
        'train_transform_unlab = [NormalizeWithMeanStd, Shift, Pad]\n'
        'Shift_offset = 0.5\n\n[network]'.format(workspace)))])
    with open(path, 'a') as f:
        f.write('\n[semi_supervised_learning]\nssl_method = '
                'EntropyMinimization\n')
    config = synchronize_config(parse_config(path))
    config['network']['num_domains'] = 1
    agent = SSLMethodDict['EntropyMinimization'](config, 'train', 'cpu')
    agent.set_transform_dict(dict(trans_dict.TransformDict, Shift=Shift))
    agent.create_dataset()
    try:
        chain = agent.train_loader_unlab.dataset.transform.transforms
    finally:
        agent.shutdown()
    assert [type(t).__name__ for t in chain] == ['NormalizeWithMeanStd',
                                                 'Shift', 'Pad']


class TinyCls(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.fc = torch.nn.Linear(params.get('input_chns', 3),
                                  params['class_num'])

    def forward(self, x, generators=None):
        return self.fc(x.mean((2, 3)))


def test_cls_agent_builds_from_injected_registries():
    from fpl_plus_torch.losses.cls import ClsLossDict
    config = {'dataset': {'task_type': 'cls'},
              'network': {'net_type': 'tiny', 'class_num': 2},
              'training': {'loss_type': 'MyCE'}, 'testing': {}}
    agent = ClassificationAgent(config, 'test', 'cpu')
    with pytest.raises(ValueError, match='Undefined network'):
        agent.create_network()
    agent.set_network_dict({'tiny': TinyCls})
    agent.set_loss_dict({'MyCE': ClsLossDict['CrossEntropyLoss']})
    agent.create_network()
    assert isinstance(agent.module, TinyCls)
    loss = agent._loss_calculator()
    assert isinstance(loss, ClsLossDict['CrossEntropyLoss'])
    with torch.no_grad():
        out = agent.module(torch.ones(2, 3, 8, 8))
    assert float(loss({'prediction': out,
                       'ground_truth': torch.tensor([0, 1])})) > 0
