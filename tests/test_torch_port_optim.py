"""PyTorch port, the optimizer factory against optax.

Every optimizer name of the registry takes 4 steps (LBFGS 5) on a 16-vector
under a fixed quadratic, lr 1e-2, momentum 0.9, weight decay 1e-4, and
ends where the JAX package's ``_base_optimizer`` ends, except Adagrad and
RMSprop: the port keeps torch's semantics, which the JAX module's own
docstring names as the contract (``engine/optim.py:6-10`` there), while its
code takes optax 0.2.6's defaults (ROADMAP.md section 3). Those two are
held against optax built with torch's hyperparameters: Adagrad with
``initial_accumulator_value=0, eps=1e-10``, RMSprop with ``decay=0.99,
eps_in_sqrt=False``. LBFGS is also held against
``optax.lbfgs(lr, linesearch=None)`` for 2 steps of a small two-layer net,
whose gradients JAX computes from the same weights.

Tolerance: f32 arithmetic in other orders, atol 1e-6 + rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fpl_plus_torch.engine.optim import LBFGS, create_optimizer

NAMES = ['SGD', 'ASGD', 'Adam', 'SparseAdam', 'Adadelta', 'Adagrad',
         'Adamax', 'RMSprop', 'Rprop', 'LBFGS']
LR, MOMENTUM, WD = 1e-2, 0.9, 1e-4


def reference(name):
    from fpl_plus_tpu.engine.optim import _base_optimizer
    decay = [optax.add_decayed_weights(WD)]
    if name == 'Adagrad':
        return optax.chain(*decay, optax.adagrad(
            LR, initial_accumulator_value=0.0, eps=1e-10))
    if name == 'RMSprop':
        return optax.chain(*decay, optax.rmsprop(
            LR, decay=0.99, eps=1e-8, momentum=MOMENTUM, eps_in_sqrt=False))
    return _base_optimizer(name, LR, MOMENTUM, WD)


@pytest.mark.parametrize('name', NAMES)
def test_optimizer_matches_optax(name):
    rs = np.random.RandomState(0)
    x0 = rs.normal(size=16).astype(np.float32)
    a = rs.uniform(0.5, 2.0, 16).astype(np.float32)
    b = rs.normal(size=16).astype(np.float32)
    steps = 5 if name == 'LBFGS' else 4

    opt = reference(name)
    x = jnp.asarray(x0)
    state = opt.init(x)
    for _ in range(steps):
        updates, state = opt.update(a * (x - b), state, x)
        x = optax.apply_updates(x, updates)

    p = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    port = create_optimizer({'optimizer': name, 'learning_rate': LR,
                             'momentum': MOMENTUM, 'weight_decay': WD}, [p])
    assert isinstance(port, LBFGS) == (name == 'LBFGS')
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for _ in range(steps):
        p.grad = ta * (p.detach() - tb)
        port.step()
    assert not np.allclose(np.asarray(x), x0)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(x),
                               rtol=1e-5, atol=1e-6)


def test_lbfgs_small_net_matches_optax():
    """Two LBFGS steps of a 4-8-3 tanh net under an MSE loss: the two-loop
    runs over all four tensors as one vector, as optax's tree ``vdot``
    does; the second step's state survives ``state_dict`` round trips."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                              torch.nn.Linear(8, 3))
    rs = np.random.RandomState(1)
    xs = rs.normal(size=(10, 4)).astype(np.float32)
    ys = rs.normal(size=(10, 3)).astype(np.float32)

    def jax_loss(params):
        h = jnp.tanh(xs @ params['w0'].T + params['b0'])
        return jnp.mean((h @ params['w1'].T + params['b1'] - ys) ** 2)

    def to_jax(module):
        sd = module.state_dict()
        return {'w0': jnp.asarray(sd['0.weight'].numpy()),
                'b0': jnp.asarray(sd['0.bias'].numpy()),
                'w1': jnp.asarray(sd['2.weight'].numpy()),
                'b1': jnp.asarray(sd['2.bias'].numpy())}

    params = to_jax(net)
    opt = optax.lbfgs(0.5, linesearch=None)
    state = opt.init(params)
    for _ in range(2):
        updates, state = opt.update(jax.grad(jax_loss)(params), state,
                                    params)
        params = optax.apply_updates(params, updates)

    port = create_optimizer({'optimizer': 'LBFGS', 'learning_rate': 0.5},
                            net.parameters())
    for i in range(2):
        port.zero_grad()
        torch.mean((net(torch.from_numpy(xs)) - torch.from_numpy(ys)) ** 2
                   ).backward()
        port.step()
        if i == 0:       # the second step runs from a restored state
            restored = create_optimizer({'optimizer': 'LBFGS',
                                         'learning_rate': 0.5},
                                        net.parameters())
            restored.load_state_dict(port.state_dict())
            port = restored
    got = to_jax(net)
    for key, want in params.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
