"""PyTorch port, the classification task against the JAX package's.

* The nets: ResNet18, VGG16 (classifier width 64) and MobileNetV2, eval
  forward of 2 RGB 32x32 images from one set of random flax variables
  (``jax.eval_shape`` of the init filled from a numpy seed) carried to the
  torchvision-named port nets by ``state_dict_from_cls``: within the 2e-4
  of ``tests/test_cls_convert.py``; ResNet18's train step (batch
  statistics, SGD) against ``jax.value_and_grad`` of the JAX forward:
  loss rtol 1e-5, gradients within 1e-4 of the largest, running
  statistics rtol 1e-5.
* ``pretrain`` with a synthesized torchvision ``.pth``: the backbone
  loaded, the head and (``input_chns = 1``) the first convolution fresh.
* The 5 losses and the metrics: within 1e-6 of JAX's; the evaluation
  CSVs read by the ``csv`` module as JAX reads them with pandas.
* 2D image I/O and ``ClassificationDataset``: equal arrays and samples.
* The agent: the test stage through ``cli test`` on the PNG workspace of
  ``tests/test_cls_agent.py`` from one checkpoint against the JAX agent's
  (network init stubbed): the same CSV headers, names and labels,
  probabilities within 1e-5; ``cli train`` + ``test`` of ``cls`` and of
  ``cls_nexcl``, and ``main_eval_cls``'s report.
"""
import csv
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpl_plus_torch.losses.cls import ClsLossDict
from fpl_plus_torch.models import cls_nets as port_nets
from fpl_plus_torch.utils.convert import state_dict_from_cls
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_zoo import random_variables

ARCHS = ('resnet18', 'vgg16', 'mobilenetv2')
FC_WIDTH = 64


def jax_and_port(arch, class_num=3, input_chns=3, seed=1):
    from fpl_plus_tpu.models import cls_nets as jax_nets
    if arch == 'vgg16':
        jm = jax_nets.VGG16(class_num=class_num, fc_width=FC_WIDTH)
        pm = port_nets.VGG16(class_num, input_chns, fc_width=FC_WIDTH)
    else:
        jm = {'resnet18': jax_nets.ResNet18,
              'mobilenetv2': jax_nets.MobileNetV2}[arch](class_num=class_num)
        pm = port_nets.TorchClsNetDict[arch]({'class_num': class_num,
                                              'input_chns': input_chns})
    x_cl = np.zeros((1, 32, 32, input_chns), np.float32)
    params, stats = random_variables(jm, x_cl, seed, call_args=(None, False))
    pm.load_state_dict(state_dict_from_cls(params, stats, arch), strict=True)
    return jm, pm, params, stats


def rgb(seed, n=2, chns=3, hw=32):
    return np.random.RandomState(seed).normal(size=(n, chns, hw, hw)).astype(
        np.float32)


@pytest.mark.parametrize('arch', ARCHS)
def test_cls_forward_matches_jax(arch):
    jm, pm, params, stats = jax_and_port(arch)
    x = rgb(3)
    want = np.asarray(jm.apply({'params': params, 'batch_stats': stats},
                               jnp.asarray(np.moveaxis(x, 1, -1)), None,
                               False))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_resnet18_train_step_matches_jax():
    """One SGD step of the agent's ``train_step`` (train-mode batch
    statistics, CrossEntropyLoss) against the JAX forward's gradient."""
    from fpl_plus_tpu.losses.cls import CrossEntropyLoss as JaxCE
    from fpl_plus_torch.agents.agent_cls import ClassificationAgent
    from fpl_plus_torch.engine.optim import create_optimizer
    jm, pm, params, stats = jax_and_port('resnet18', class_num=2,
                                         input_chns=1, seed=2)
    x = rgb(4, n=4, chns=1)
    labels = np.array([0, 1, 1, 0])

    def loss_fn(p):
        out, upd = jm.apply({'params': p, 'batch_stats': stats},
                            jnp.asarray(np.moveaxis(x, 1, -1)), None, True,
                            mutable=['batch_stats'])
        return JaxCE()({'prediction': out,
                        'ground_truth': jnp.asarray(labels)}), upd
    (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    cfg = {'dataset': {'task_type': 'cls'},
           'network': {'net_type': 'resnet18', 'class_num': 2,
                       'input_chns': 1},
           'training': {'optimizer': 'SGD', 'learning_rate': 0.1,
                        'momentum': 0.0, 'weight_decay': 0.0},
           'testing': {}}
    agent = ClassificationAgent(cfg, 'train', 'cpu')
    agent.module = pm.train()
    optimizer = create_optimizer(cfg['training'], pm.parameters())
    got_loss, _ = agent.train_step(optimizer, agent._loss_calculator(),
                                   torch.from_numpy(x),
                                   torch.from_numpy(labels), 0)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    want_grads = state_dict_from_cls(jax.device_get(grads), jax.device_get(
        upd['batch_stats']), 'resnet18')
    top = max(float(g.abs().max()) for k, g in want_grads.items()
              if not k.endswith(('running_mean', 'running_var',
                                 'num_batches_tracked')))
    for name, p in pm.named_parameters():
        err = float((p.grad - want_grads[name]).abs().max())
        assert err <= 1e-4 * top, (name, err, top)
    for name, b in pm.named_buffers():
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(b.numpy(), want_grads[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize('arch', ARCHS)
def test_pretrained_backbone_loads_head_stays_fresh(arch, tmp_path):
    """A synthesized torchvision ``.pth`` (1000 classes, 3 input
    channels) into a 2-class, 1-channel net: every other tensor equals the
    file's; the head and the first convolution keep their fresh values."""
    from tests import test_cls_convert as synth
    rs = np.random.RandomState(5)
    sd = {'resnet18': lambda: synth.synth_resnet18(rs, 1000),
          'vgg16': lambda: synth.synth_vgg16(rs, 1000, FC_WIDTH),
          'mobilenetv2': lambda: synth.synth_mobilenetv2(rs, 1000)}[arch]()
    pth = str(tmp_path / 'tv.pth')
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    torch.manual_seed(0)
    if arch == 'vgg16':
        net = port_nets.VGG16(2, 1, fc_width=FC_WIDTH)
        port_nets.load_pretrained(net, arch, pth, input_chns=1)
    else:
        from fpl_plus_torch.agents.agent_cls import ClassificationAgent
        cfg = {'dataset': {'task_type': 'cls'},
               'network': {'net_type': arch, 'class_num': 2,
                           'input_chns': 1, 'pretrain': True,
                           'pretrained_path': pth},
               'training': {}, 'testing': {}}
        agent = ClassificationAgent(cfg, 'train', 'cpu')
        agent.create_network()
        net = agent.module
    first, head = port_nets.FIRST_CONV[arch], port_nets.HEAD[arch]
    loaded = 0
    for name, value in net.state_dict().items():
        if name.startswith((first, head)):
            assert name not in sd or value.shape != sd[name].shape or \
                not np.array_equal(value.numpy(), sd[name]), name
        elif name in sd:
            np.testing.assert_array_equal(value.numpy(), sd[name])
            loaded += 1
    assert loaded > 10
    assert net.state_dict()[head + 'weight'].shape[0] == 2
    assert net.state_dict()[first + 'weight'].shape[1] == 1


@pytest.mark.parametrize('name', sorted(ClsLossDict))
def test_cls_loss_matches_jax(name):
    from fpl_plus_tpu.losses.cls import ClsLossDict as JaxLoss
    rs = np.random.RandomState(6)
    logits = rs.normal(size=(5, 3)).astype(np.float32) * 2
    labels = rs.randint(0, 3, 5)
    if name == 'SigmoidCELoss':
        labels = (rs.uniform(size=(5, 3)) > 0.5).astype(np.float32)
    want = float(JaxLoss[name]()({'prediction': jnp.asarray(logits),
                                  'ground_truth': jnp.asarray(labels)}))
    got = ClsLossDict[name]()({'prediction': torch.from_numpy(logits),
                               'ground_truth': torch.from_numpy(labels)})
    assert abs(float(got) - want) <= 1e-6, (float(got), want)


def write_eval_csvs(root, rs, n=20, k=3):
    gt = rs.randint(0, 2, (n, k))
    prob = np.round(rs.uniform(size=(n, k)), 3)
    prob[:4] = 0.5                               # ties for the rank AUC
    names = ['img/c{0}.png'.format(i) for i in range(n)]
    paths = {}
    for tag, cols, rows in (
            ('gt_bin', ['image', 'label'], [[m, g] for m, g in
                                            zip(names, gt[:, 0])]),
            ('prob_bin', ['image', 'prob0', 'prob1'],
             [[m, 1 - p, p] for m, p in zip(names, prob[:, 0])]),
            ('gt_nexcl', ['image'] + ['label{0}'.format(c) for c in range(k)],
             [[m] + list(g) for m, g in zip(names, gt)]),
            ('prob_nexcl', ['image'] + ['prob{0}'.format(c)
                                        for c in range(k)],
             [[m] + list(p) for m, p in zip(names, prob)])):
        paths[tag] = os.path.join(root, tag + '.csv')
        with open(paths[tag], 'w', newline='') as f:
            csv.writer(f).writerows([cols] + rows)
    return paths


def test_cls_metrics_match_jax(tmp_path):
    from fpl_plus_tpu.metrics import cls_metrics as jax_metrics
    from fpl_plus_torch.metrics import cls_metrics
    rs = np.random.RandomState(7)
    gt = rs.randint(0, 2, 50)
    pred = rs.randint(0, 2, 50)
    score = np.round(rs.uniform(size=50), 2)
    for f in ('accuracy', 'recall', 'specificity', 'precision'):
        assert getattr(cls_metrics, f)(gt, pred) == pytest.approx(
            getattr(jax_metrics, f)(gt, pred), abs=1e-6), f
    assert cls_metrics.roc_auc(gt, score) == pytest.approx(
        jax_metrics.roc_auc(gt, score), abs=1e-6)
    paths = write_eval_csvs(str(tmp_path), rs)
    metrics = ['accuracy', 'recall', 'specificity', 'precision', 'auc']
    for kind in ('bin', 'nexcl'):
        config = {'metric_list': metrics,
                  'ground_truth_csv': paths['gt_' + kind],
                  'predict_prob_csv': paths['prob_' + kind]}
        evaluate = 'binary_evaluation' if kind == 'bin' else \
            'nexcl_evaluation'
        want = getattr(jax_metrics, evaluate)(config)
        got = getattr(cls_metrics, evaluate)(config)
        assert set(got) == set(want)
        for m in metrics:
            np.testing.assert_allclose(got[m], want[m], atol=1e-6,
                                       err_msg=m)


def test_rgb_image_io_matches_jax(tmp_path):
    from fpl_plus_tpu.io import image_io as jax_io
    from fpl_plus_torch.io import image_io
    rs = np.random.RandomState(8)
    grey = rs.randint(0, 256, (20, 24)).astype(np.uint8)
    colour = rs.randint(0, 256, (3, 20, 24)).astype(np.uint8)
    image_io.save_nd_array_as_image(grey, str(tmp_path / 'g.png'))
    image_io.save_array_as_rgb_image(colour, str(tmp_path / 'c.png'))
    jax_io.save_array_as_rgb_image(colour, str(tmp_path / 'c_jax.png'))
    for name, want in (('g.png', grey[None]), ('c.png', colour),
                       ('c_jax.png', colour)):
        got = image_io.load_image_as_nd_array(str(tmp_path / name))
        ref = jax_io.load_image_as_nd_array(str(tmp_path / name))
        np.testing.assert_array_equal(got['data_array'], want)
        np.testing.assert_array_equal(got['data_array'], ref['data_array'])
        assert got['spacing'] == ref['spacing']
    with pytest.raises(ValueError):          # a 2D array is no volume
        image_io.save_nd_array_as_image(grey, str(tmp_path / 'x.nii.gz'))


@pytest.fixture(scope='module')
def cls_workspace(tmp_path_factory):
    """``tests/test_cls_agent.py``'s workspace: 12 grey 32x32 PNGs, bright
    (label 1) or dark (label 0); 8 train, 2 valid, 2 test."""
    from PIL import Image
    root = tmp_path_factory.mktemp('torch_port_cls')
    rs = np.random.RandomState(3)
    os.makedirs(root / 'img')
    rows_train, rows_valid, rows_test = [], [], []
    for i in range(12):
        label = i % 2
        img = np.clip(rs.normal(64 + label * 128, 20, size=(32, 32)), 0,
                      255).astype(np.uint8)
        name = 'img/c{0}.png'.format(i)
        Image.fromarray(img).save(str(root / name))
        row = '{0},{1}'.format(name, label)
        (rows_train if i < 8 else rows_valid if i < 10
         else rows_test).append(row)
    (root / 'train.csv').write_text('image,label\n' + '\n'.join(rows_train)
                                    + '\n')
    (root / 'valid.csv').write_text('image,label\n' + '\n'.join(rows_valid)
                                    + '\n')
    (root / 'test.csv').write_text('image\n' + '\n'.join(
        r.split(',')[0] for r in rows_test) + '\n')
    (root / 'test_gt.csv').write_text('image,label\n' + '\n'.join(
        rows_test) + '\n')
    (root / 'test_gt_nexcl.csv').write_text(
        'image,label0,label1\n' + ''.join('{0},{1},{2}\n'.format(
            r.split(',')[0], 1 - int(r[-1]), r[-1]) for r in rows_test))
    return root


def test_classification_dataset_matches_jax(cls_workspace):
    from fpl_plus_tpu.io.dataset import ClassificationDataset as JaxDataset
    from fpl_plus_torch.io.dataset import ClassificationDataset
    root = str(cls_workspace)
    for csv_name, with_label in (('train.csv', True), ('test.csv', False)):
        ref = JaxDataset(root, os.path.join(root, csv_name), 1, 2,
                         with_label)
        got = ClassificationDataset(root, os.path.join(root, csv_name), 1,
                                    2, with_label)
        assert len(got) == len(ref)
        for i in range(len(ref)):
            a, b = ref[i], got[i]
            assert a['names'] == b['names']
            np.testing.assert_array_equal(b['image'], a['image'])
            assert b['image'].dtype == np.float32
            if with_label:
                assert b['label'] == a['label']
                assert b['label'].dtype == np.int64


CLS_CFG = """
[dataset]
task_type = {task}
root_dir = {root}
modal_num = 1
train_csv = {root}/train.csv
valid_csv = {root}/valid.csv
test_csv = {root}/test.csv
train_batch_size = 4
num_workder = 0
{transforms}

[network]
net_type = resnet18
class_num = 2
input_chns = 1
pretrain = False

[training]
loss_type = {loss}
optimizer = Adam
learning_rate = 1e-3
momentum = 0.9
weight_decay = 0.0
lr_scheduler = None
iter_start = 0
iter_max = 6
iter_valid = 3
random_seed = 1
ckpt_save_dir = {root}/model/{run}

[testing]
ckpt_mode = {mode}
output_csv = {root}/{out}.csv
save_probability = True

[evaluation]
task_type = {task}
metric_list = [accuracy, auc]
ground_truth_csv = {root}/{gt}
predict_prob_csv = {root}/{out}_prob.csv
"""
NEXCL_CHAINS = """train_transform = [LabelToProbability]
valid_transform = [LabelToProbability]"""


def cls_cfg(root, run, out, task='cls', loss='CrossEntropyLoss', mode=1,
            transforms='', gt='test_gt.csv'):
    path = os.path.join(root, out + '.cfg')
    with open(path, 'w') as f:
        f.write(CLS_CFG.format(root=root, run=run, out=out, task=task,
                               loss=loss, mode=mode, transforms=transforms,
                               gt=gt))
    return path


def test_test_stage_csvs_match_jax(cls_workspace, monkeypatch):
    """One random ResNet18 checkpoint (``.ckpt`` for JAX, ``.pt`` for the
    port): the JAX agent's test stage and ``cli test`` write the same
    headers, names and labels, and probabilities within 1e-5."""
    from fpl_plus_tpu.agents.agent_cls import ClassificationAgent as JaxAgent
    from fpl_plus_tpu.config.parser import parse_config as jax_parse
    from fpl_plus_tpu.engine import ckpt as jax_ckpt
    from fpl_plus_torch.cli import main
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = str(cls_workspace)
    jm, _, params, stats = jax_and_port('resnet18', 2, 1, seed=9)
    ckpt_dir = os.path.join(root, 'model', 'fixed')
    jax_ckpt.save_checkpoint(ckpt_dir, 'fixed', 6, {
        'params': jax.device_get(params), 'batch_stats': stats,
        'opt_state': ()}, 0.5)
    torch.save({'iteration': 6, 'valid_pred': 0.5, 'model_state_dict':
                state_dict_from_cls(params, stats, 'resnet18')},
               os.path.join(ckpt_dir, 'fixed_6.pt'))

    def stub_init(self):     # the JAX init's eager compiles, skipped
        self.module = jm
        self.variables = {'params': params, 'batch_stats': stats}

    monkeypatch.setattr(JaxAgent, 'create_network', stub_init)
    JaxAgent(jax_parse(cls_cfg(root, 'fixed', 'jax_pred', mode=0)),
             'test').run()
    assert main(['test', cls_cfg(root, 'fixed', 'port_pred', mode=0)],
                device='cpu') == 0
    for suffix in ('.csv', '_prob.csv'):
        want = read_rows(os.path.join(root, 'jax_pred' + suffix))
        got = read_rows(os.path.join(root, 'port_pred' + suffix))
        assert got[0] == want[0]
        assert [r[0] for r in got] == [r[0] for r in want]
        if suffix == '.csv':
            assert got == want
        else:
            np.testing.assert_allclose(
                np.asarray([r[1:] for r in got[1:]], np.float64),
                np.asarray([r[1:] for r in want[1:]], np.float64),
                atol=1e-5)
    assert read_rows(os.path.join(root, 'port_pred.csv'))[0] == \
        ['image', 'label']


def read_rows(path):
    with open(path, newline='') as f:
        return list(csv.reader(f))


@pytest.mark.parametrize('task', ['cls', 'cls_nexcl'])
def test_cli_train_test_and_evaluation(task, cls_workspace, monkeypatch):
    """``cli train`` (6 iterations, validation every 3, checkpoints with
    their pointers), ``cli test`` from the best one, and ``main_eval_cls``
    on the probabilities: JAX's headers, 2 rows, a report."""
    from fpl_plus_torch.cli import main, main_eval_cls
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = str(cls_workspace)
    nexcl = task == 'cls_nexcl'
    cfg = cls_cfg(root, task, task + '_pred', task=task,
                  loss='SigmoidCELoss' if nexcl else 'CrossEntropyLoss',
                  transforms=NEXCL_CHAINS if nexcl else '',
                  gt='test_gt_nexcl.csv' if nexcl else 'test_gt.csv')
    assert main(['train', cfg], device='cpu') == 0
    model = os.path.join(root, 'model', task)
    assert os.path.isfile(os.path.join(model, task + '_best.txt'))
    assert {task + '_3.pt', task + '_6.pt'} <= set(os.listdir(model))
    assert not os.path.exists(os.path.join(root, task + '_pred.csv'))
    assert main(['test', cfg], device='cpu') == 0
    lines = read_rows(os.path.join(root, task + '_pred.csv'))
    assert lines[0] == (['image', 'label0', 'label1'] if nexcl
                        else ['image', 'label'])
    assert [r[0] for r in lines[1:]] == ['img/c10.png', 'img/c11.png']
    probs = read_rows(os.path.join(root, task + '_pred_prob.csv'))
    assert probs[0] == ['image', 'prob0', 'prob1'] and len(probs) == 3
    assert main_eval_cls([cfg]) == 0
    report = read_rows(os.path.join(root, task + '_pred_prob_eval.csv'))
    assert [r[0] for r in report] == ['accuracy', 'auc']
    assert all(0.0 <= float(v) <= 1.0 for r in report for v in r[1:])
    if nexcl:
        return
    # a resume from iteration 6 to 9 restores the optimizer state
    with open(cfg) as f, open(cfg + '.resume', 'w') as g:
        g.write(f.read().replace('iter_start = 0', 'iter_start = 6')
                .replace('iter_max = 6', 'iter_max = 9'))
    assert main(['train', cfg + '.resume'], device='cpu') == 0
    saved = torch.load(os.path.join(model, task + '_9.pt'),
                       weights_only=False)
    steps = {int(v['step']) for v in
             saved['optimizer_state_dict']['state'].values()}
    assert steps == {9}


def test_bf16_train_step_keeps_f32_state():
    """``[training] precision = bfloat16``: a finite loss from bf16 copies,
    f32 parameters, gradients and BN statistics after the step."""
    from fpl_plus_torch.agents.agent_cls import ClassificationAgent
    from fpl_plus_torch.engine.optim import create_optimizer
    cfg = {'dataset': {'task_type': 'cls'},
           'network': {'net_type': 'mobilenetv2', 'class_num': 2,
                       'input_chns': 3},
           'training': {'optimizer': 'Adam', 'learning_rate': 1e-3,
                        'precision': 'bfloat16',
                        'loss_type': 'CrossEntropyLoss'},
           'testing': {}}
    agent = ClassificationAgent(cfg, 'train', 'cpu')
    agent.create_network()
    net = agent.module.train()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    loss, out = agent.train_step(
        create_optimizer(cfg['training'], net.parameters()),
        agent._loss_calculator(), torch.from_numpy(rgb(5)),
        torch.tensor([0, 1]), 0)
    assert np.isfinite(float(loss)) and out.dtype == torch.float32
    for k, v in net.state_dict().items():
        assert v.dtype == before[k].dtype, k
    assert all(p.grad.dtype == torch.float32 for p in net.parameters())
    assert not torch.equal(net.state_dict()['features.0.1.running_mean'],
                           before['features.0.1.running_mean'])
