"""PyTorch port, the discriminator (``dis = True``): ``InstanceNorm`` and
``Dis`` against the flax modules, one discriminator step against the JAX
agent's ``dis_step``, and the discriminator's state in the train stage's
checkpoints.

One JAX program is compiled: the JAX agent's jitted discriminator step
(eval-mode forwards of the tiny UNet2D5_dsbn, feature_chns [4,8,8,8,8], on
one [28,32,32] crop per domain, softmax, the flax ``Dis`` on the maps and
the labels, and the LSGAN Adam update at 1e-4, betas (0.5, 0.999)) from
the port's seeded discriminator weights, carried over in the flax layout
and back through ``dis_state_dict_from_jax``. Tolerances: InstanceNorm
atol 1e-5 (one normalisation, f32); ``loss_dis`` rtol 1e-4;
the discriminator's parameters after the update by
``test_torch_port_train_step.py``'s Adam rule (0.5 x the rate where the
gradient, Adam's first moment / 0.5, is above 10 x its tolerance, 4 x the
rate elsewhere: the convolution biases before an InstanceNorm have a zero
gradient in exact arithmetic, so Adam moves them by a sign of noise).
"""
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fpl_plus_torch.agents.agent_seg import init_dis
from fpl_plus_torch.cli import main as torch_main
from fpl_plus_torch.engine.train import DiscriminatorStep
from fpl_plus_torch.models.dsbn import InstanceNorm
from fpl_plus_torch.models.registry import create_network
from fpl_plus_torch.utils.convert import dis_state_dict_from_jax
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_train_step import (CLI_CFG, TINY, _cl,
                                              _port_names, adam_mu,
                                              tiny_variables)
from tests.test_torch_port_train_units import write_train_domain

DIS_LR = 1e-4


def test_instance_norm_matches_flax():
    from fpl_plus_tpu.models.dsbn import InstanceNorm as JaxInstanceNorm
    x = (np.random.RandomState(3).normal(size=(2, 5, 3, 6, 7)) * 2
         + 1).astype(np.float32)
    want = JaxInstanceNorm().apply({}, jnp.asarray(_cl(x)))
    got = InstanceNorm(5)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want),
                                                        -1, 1), atol=1e-5)


def test_dis_step_matches_jax():
    from fpl_plus_tpu.agents.agent_seg import SegmentationAgent as JaxAgent
    from fpl_plus_tpu.engine.train import TrainState
    from fpl_plus_tpu.models.registry import create_network as jax_network
    import optax
    module = jax_network(TINY)
    params, stats = tiny_variables(2)
    dis_step = JaxAgent._build_dis_step(types.SimpleNamespace(
        module=module))
    # the discriminator's initial weights: the port's seeded init, in the
    # flax layout (a flax init runs op by op here, ~0.25 s of compile each)
    dis = create_network({'net_type': 'Dis', 'class_num': 2})
    init_dis(dis, 11)
    dis0 = {'Conv_{0}'.format(i): {
        'kernel': np.transpose(c.weight.detach().numpy(), (2, 3, 4, 1, 0)),
        'bias': c.bias.detach().numpy()}
        for i, c in enumerate(list(dis.convs) + [dis.out_conv])}
    dis.load_state_dict(dis_state_dict_from_jax(dis0), strict=True)
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=None, extra={'dis_params': dis0, 'dis_opt': optax.adam(
            DIS_LR, b1=0.5, b2=0.999).init(dis0)})

    rs = np.random.RandomState(5)
    batches = []
    for d in range(2):
        x = rs.normal(size=(1, 1, 28, 32, 32)).astype(np.float32) + d
        y = (x[:, 0] > 0.6 + d).astype(np.int64)
        batches.append({'image': x, 'label_prob': np.moveaxis(
            np.eye(2, dtype=np.float32)[y], -1, 1)})
    state, ref = dis_step(state, tuple({k: _cl(v) for k, v in b.items()}
                                       for b in batches),
                          jax.random.PRNGKey(0))
    ref_dis, ref_mu = jax.device_get((state.extra['dis_params'],
                                      adam_mu(state.extra['dis_opt'])))

    net = create_network(TINY)
    net.load_state_dict(_port_names(params, stats), strict=True)
    net.train()
    opt = torch.optim.Adam(dis.parameters(), lr=DIS_LR, betas=(0.5, 0.999))
    m = DiscriminatorStep(net, dis, opt)(
        [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches])
    np.testing.assert_allclose(float(m['loss_dis']), float(ref['loss_dis']),
                               rtol=1e-4)
    assert net.training
    assert all(int(v) == 0 for k, v in net.state_dict().items()
               if k.endswith('num_batches_tracked'))
    want_p = dis_state_dict_from_jax(ref_dis)
    grads = dis_state_dict_from_jax(jax.tree_util.tree_map(
        lambda v: v / 0.5, ref_mu))
    top = max(float(g.abs().max()) for g in grads.values())
    for name, p in dis.state_dict().items():
        err = (p - want_p[name]).abs().numpy()
        g = grads[name].abs().numpy()
        signal = g > 10 * (1e-3 * g.max() + 1e-5 * top)
        assert err[signal].max(initial=0) <= 0.5 * DIS_LR, name
        assert err.max() <= 4 * DIS_LR, name


def test_dis_state_rides_in_checkpoints(tmp_path, monkeypatch):
    """``cli train`` with ``dis = True`` at [28,32,32] crops: every
    checkpoint holds the discriminator and its Adam; a resume restores
    them; a checkpoint without them starts a fresh discriminator and logs
    it."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = str(tmp_path)
    rs = np.random.RandomState(2)
    for d in (0, 1):
        write_train_domain(root, d, rs, n=2, shape=(28, 32, 32))

    def cfg(start, stop):
        path = os.path.join(root, 'dis{0}.cfg'.format(start))
        text = CLI_CFG.format(root=root, extra='dis = True').replace(
            '[8, 16, 16]', '[28, 32, 32]').replace(
            '[6, 12, 12]', '[28, 32, 32]').replace(
            'iter_start = 0', 'iter_start = {0}'.format(start)).replace(
            'iter_max = 2', 'iter_max = {0}'.format(stop)).replace(
            'train_batch_size = 2', 'train_batch_size = 1')
        with open(path, 'w') as f:
            f.write(text)
        return path

    seen = []
    real_call = DiscriminatorStep.__call__

    def recording_call(self, batches):
        seen.append({k: v.clone() for k, v in self.dis.state_dict().items()})
        return real_call(self, batches)

    monkeypatch.setattr(DiscriminatorStep, '__call__', recording_call)
    assert torch_main(['train', cfg(0, 2)], device='cpu') == 0
    ckpt_dir = os.path.join(root, 'model', 'gen')
    saved = torch.load(os.path.join(ckpt_dir, 'gen_2.pt'), weights_only=False)
    assert sorted(saved['dis_state_dict']) == sorted(seen[0])
    assert {int(s['step']) for s in saved['dis_optimizer_state_dict'][
        'state'].values()} == {2}
    assert len(seen) == 2

    assert torch_main(['train', cfg(2, 4)], device='cpu') == 0
    for k, v in saved['dis_state_dict'].items():
        assert torch.equal(seen[2][k], v), k
    with open(os.path.join(ckpt_dir, 'log_train.txt')) as f:
        assert 'restored the discriminator' in f.read()

    del saved['dis_state_dict'], saved['dis_optimizer_state_dict']
    torch.save(saved, os.path.join(ckpt_dir, 'gen_2.pt'))
    assert torch_main(['train', cfg(2, 4)], device='cpu') == 0
    for k, v in seen[0].items():
        assert torch.equal(seen[4][k], v), k     # the seeded fresh one
    with open(os.path.join(ckpt_dir, 'log_train.txt')) as f:
        assert 'no discriminator state; fresh discriminator' in f.read()
