"""PyTorch port, the segmentation losses and deep supervision: every loss of
the registry and ``DeepSuperviseLoss`` against the JAX package's on the same
logits (f32, rtol 1e-5), and two ``UNet2D`` deep-supervision train steps
(dropout 0, Adam, single domain) against JAX's ``make_train_step`` at the
joint step's tolerances (``tests/test_torch_port_train_step.py``).

One JAX train step is compiled for the file; the losses run eagerly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpl_plus_torch.engine.optim import create_lr_schedule, create_optimizer
from fpl_plus_torch.engine.train import JointTrainStep
from fpl_plus_torch.losses import SegLossDict, create_loss_calculator
from fpl_plus_torch.losses.seg import DeepSuperviseLoss, DiceLoss
from fpl_plus_torch.models.registry import create_network
from fpl_plus_torch.utils.convert import state_dict_from_flax
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_train_step import (adam_mu, check_grads,
                                              check_params)
from tests.test_torch_port_zoo import random_variables

PARAMS = {'focaldiceloss_beta': 2.0, 'noiserobustdiceloss_gamma': 1.5,
          'loss_gce_q': 0.7, 'explogloss_w_dice': 0.6,
          'explogloss_gamma': 0.3, 'slsrloss_epsilon': 0.2,
          'mumfordshahloss_lambda': 0.5}
# id: (loss name, extra params, prediction rank, keys beyond the two)
CASES = {
    'CrossEntropyLoss': ('CrossEntropyLoss', {}, 5, ('pixel_weight',)),
    'GeneralizedCELoss': ('GeneralizedCELoss', {}, 5, ()),
    'GeneralizedCELoss-weighted': (
        'GeneralizedCELoss', {'loss_with_pixel_weight': True,
                              'loss_class_weight': [0.2, 0.3, 0.5]}, 5,
        ('pixel_weight',)),
    'DiceLoss': ('DiceLoss', {}, 5, ('pixel_weight',)),
    'DiceLoss_weight': ('DiceLoss_weight', {}, 5,
                        ('pixel_weight', 'image_weight')),
    'FocalDiceLoss': ('FocalDiceLoss', {}, 5, ()),
    'NoiseRobustDiceLoss': ('NoiseRobustDiceLoss', {}, 5, ()),
    'ExpLogLoss': ('ExpLogLoss', {}, 5, ()),
    'MAELoss': ('MAELoss', {}, 5, ()),
    'MSELoss': ('MSELoss', {}, 4, ()),
    'SLSRLoss': ('SLSRLoss', {}, 5, ('pixel_weight',)),
    'SLSRLoss-plain': ('SLSRLoss', {}, 5, ()),
    'EntropyLoss': ('EntropyLoss', {}, 5, ()),
    'TotalVariationLoss': ('TotalVariationLoss', {}, 5, ()),
    'TotalVariationLoss-2d': ('TotalVariationLoss', {}, 4, ()),
    'MumfordShahLoss': ('MumfordShahLoss', {}, 5, ('image',)),
    'MumfordShahLoss-l2-2d': ('MumfordShahLoss',
                              {'mumfordshahloss_penalty': 'l2'}, 4,
                              ('image',)),
}


def _arrays(rank, seed):
    rs = np.random.RandomState(seed)
    sp = (4, 8, 8)[5 - rank:]
    y = rs.randint(0, 3, size=(2,) + sp)
    return {'prediction': rs.normal(size=(2, 3) + sp).astype(np.float32),
            'ground_truth': np.moveaxis(np.eye(3, dtype=np.float32)[y], -1,
                                        1),
            'pixel_weight': ((rs.uniform(size=(2, 1) + sp) > 0.3)
                             * rs.uniform(0.5, 1.0, (2, 1) + (1,) * len(sp))
                             ).astype(np.float32),
            'image_weight': rs.uniform(0.1, 1.0, 2).astype(np.float32),
            'image': rs.normal(size=(2, 2) + sp).astype(np.float32)}


def _cl(key, a):
    return jnp.asarray(a if key == 'image_weight' else np.moveaxis(a, 1, -1))


@pytest.mark.parametrize('case', sorted(CASES))
def test_loss_matches_jax(case):
    from fpl_plus_tpu.losses import SegLossDict as JaxLossDict
    name, extra, rank, keys = CASES[case]
    params = dict(PARAMS, loss_type=name, **extra)
    arrays = _arrays(rank, len(case))
    keys = ('prediction', 'ground_truth') + keys
    ref = JaxLossDict[name](params)({k: _cl(k, arrays[k]) for k in keys})
    got = create_loss_calculator({'training': params})(
        {k: torch.from_numpy(arrays[k]) for k in keys})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


def test_deep_supervise_loss_matches_jax():
    """``create_loss_calculator`` wraps the base loss for ``[network]
    deep_supervise`` with ``deep_supervise_weight``; the weighted mean over
    a list of heads equals JAX's, a single head is refused, and every loss
    reads the first head of a list."""
    from fpl_plus_tpu.losses import create_loss_calculator as jax_loss
    heads = [_arrays(5, s)['prediction'] for s in (1, 2, 3)]
    y = _arrays(5, 1)['ground_truth']
    config = {'training': {'loss_type': ['DiceLoss', 'CrossEntropyLoss'],
                           'loss_weight': [0.7, 0.3]},
              'network': {'deep_supervise': True,
                          'deep_supervise_weight': [1.0, 0.5, 0.25]}}
    ref = jax_loss(config)({'prediction': [_cl('p', h) for h in heads],
                            'ground_truth': _cl('y', y)})
    loss = create_loss_calculator(config)
    assert isinstance(loss, DeepSuperviseLoss)
    got = loss({'prediction': [torch.from_numpy(h) for h in heads],
                'ground_truth': torch.from_numpy(y)})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    with pytest.raises(ValueError, match='list prediction'):
        loss({'prediction': torch.from_numpy(heads[0]),
              'ground_truth': torch.from_numpy(y)})
    first = DiceLoss()({'prediction': [torch.from_numpy(h) for h in heads],
                        'ground_truth': torch.from_numpy(y)})
    alone = DiceLoss()({'prediction': torch.from_numpy(heads[0]),
                        'ground_truth': torch.from_numpy(y)})
    assert float(first) == float(alone)
    assert len(SegLossDict) == 13


NET = {'net_type': 'UNet2D', 'in_chns': 1, 'class_num': 2,
       'feature_chns': [4, 8, 8, 16], 'dropout': [0.0] * 4,
       'deep_supervise': True}
TRAIN_CFG = {'optimizer': 'Adam', 'learning_rate': 1e-3, 'momentum': 0.9,
             'weight_decay': 0.0, 'lr_scheduler': 'MultiStepLR',
             'lr_gamma': 0.5, 'lr_milestones': [1], 'loss_type': 'DiceLoss'}
LR = TRAIN_CFG['learning_rate']


def test_deep_supervision_train_step_matches_jax():
    """Two single-domain joint steps of the deep-supervised UNet2D (2.5D
    crops, 2 aux heads resized inside the net): loss, dice of the primary
    head, the first step's gradients (from JAX's Adam first moment), the
    parameters and BatchNorm statistics after both steps."""
    from fpl_plus_tpu.engine.optim import create_optimizer as jax_optimizer
    from fpl_plus_tpu.engine.train import create_train_state, make_train_step
    from fpl_plus_tpu.losses import create_loss_calculator as jax_loss
    from fpl_plus_tpu.models.registry import create_network as jax_network
    config = {'training': TRAIN_CFG, 'network': NET}
    rs = np.random.RandomState(9)
    batches = []
    for _ in range(2):
        x = rs.normal(size=(2, 1, 3, 16, 16)).astype(np.float32)
        y = (x[:, 0] > 0.6).astype(np.int64)
        batches.append({'image': x, 'label_prob': np.moveaxis(
            np.eye(2, dtype=np.float32)[y], -1, 1)})
    module = jax_network(NET)
    params, stats = random_variables(module, np.moveaxis(batches[0]['image'],
                                                         1, -1), seed=4)
    optimizer = jax_optimizer(TRAIN_CFG, dict(TRAIN_CFG, last_iter=-1))
    step = make_train_step(module.apply, jax_loss(config), optimizer,
                           num_domains=1, joint=True)
    state = create_train_state(params, stats, optimizer)
    ref_metrics, ref_grads = [], None
    for i, b in enumerate(batches):
        state, m = step(state, ({k: _cl(k, v) for k, v in b.items()},),
                        jax.random.PRNGKey(i))
        ref_metrics.append(jax.device_get(m))
        if i == 0:
            ref_grads = jax.tree_util.tree_map(
                lambda mu: np.asarray(mu) / 0.1, adam_mu(state.opt_state))
    ref_params, ref_stats = jax.device_get((state.params, state.batch_stats))

    net = create_network(NET)
    net.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    net.train()
    opt = create_optimizer(TRAIN_CFG, net.parameters())
    port = JointTrainStep(net, create_loss_calculator(config), opt,
                          create_lr_schedule(dict(TRAIN_CFG, last_iter=-1)),
                          num_domains=1)
    for i, b in enumerate(batches):
        m = port([{k: torch.from_numpy(v) for k, v in b.items()}], [None])
        for key in ('loss', 'class_dice_0'):
            np.testing.assert_allclose(m[key].numpy(), ref_metrics[i][key],
                                       rtol=1e-4, err_msg=key)
        if i == 0:
            check_grads(ref_grads, stats, {
                k: p.grad for k, p in net.named_parameters()},
                to_port=state_dict_from_flax)
    check_params(ref_params, ref_stats, ref_grads, net.state_dict(), LR,
                 to_port=state_dict_from_flax)
