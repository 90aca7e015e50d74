"""Write the JAX-checkpoint fixture that the converter's tests and
``chip_smoke.py`` phase 29 read, on the CPU with the JAX package:

    JAX_PLATFORMS=cpu python tools/make_jax_ckpt_fixture.py

Into ``tests/data/jax_ckpt/`` (under 1 MB in all):

* ``net.cfg``: the ``[network]`` section of a narrow UNet2D5_dsbn
  (``FIXTURE_NET``);
* ``jax_3.ckpt``: the JAX package's ``engine/ckpt.save_checkpoint`` of its
  variables (flax init from ``SEED``, DSBN statistics and PReLU slopes
  replaced by seeded random values so that both banks differ) with an
  optax Adam state, iteration 3;
* ``window.npz``: ``x``, one seeded [1,1,8,32,32] window, and
  ``logits_d0`` / ``logits_d1``, the JAX eval forward's logits on it for
  domain 0 and 1 (channels-first), at f32.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FIXTURE_NET = {'net_type': 'UNet2D5_dsbn', 'num_domains': 2, 'class_num': 2,
               'in_chns': 1, 'feature_chns': [4, 8, 8, 16, 16],
               'conv_dims': [2, 2, 3, 3, 3],
               'dropout': [0.0, 0.0, 0.3, 0.4, 0.5], 'bilinear': False}
WINDOW = (1, 1, 8, 32, 32)
SEED = 20261017
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'tests', 'data', 'jax_ckpt')


def randomize(tree, rs):
    """Seeded DSBN statistics (var in [0.5, 2]) and PReLU slopes."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = randomize(value, rs)
        elif key == 'var':
            out[key] = rs.uniform(0.5, 2.0, np.shape(value)).astype(
                np.float32)
        elif key in ('mean', 'alpha'):
            scale = 0.5 if key == 'mean' else 0.1
            out[key] = (rs.normal(0, scale, np.shape(value))
                        + (0.25 if key == 'alpha' else 0.0)).astype(
                            np.float32)
        else:
            out[key] = np.asarray(value)
    return out


def main():
    import jax
    import jax.numpy as jnp
    import optax

    from fpl_plus_tpu.engine.ckpt import save_checkpoint
    from fpl_plus_tpu.models.registry import create_network

    module = create_network(FIXTURE_NET)
    variables = jax.jit(lambda: module.init(
        {'params': jax.random.PRNGKey(SEED),
         'dropout': jax.random.PRNGKey(SEED + 1)},
        jnp.zeros((1,) + WINDOW[2:] + (1,), jnp.float32), 0, True))()
    rs = np.random.RandomState(SEED)
    params = randomize(jax.device_get(variables['params']), rs)
    stats = randomize(jax.device_get(variables['batch_stats']), rs)
    opt_state = jax.device_get(optax.adam(1e-4).init(params))
    os.makedirs(OUT, exist_ok=True)
    save_checkpoint(OUT, 'jax', 3, {'params': params, 'batch_stats': stats,
                                    'opt_state': opt_state}, 0.5)
    x = rs.normal(size=WINDOW).astype(np.float32)
    fwd = jax.jit(lambda v, xx, d: module.apply(v, xx, d, False))
    logits = {}
    for domain in (0, 1):
        out = fwd({'params': params, 'batch_stats': stats},
                  jnp.asarray(np.moveaxis(x, 1, -1)), jnp.int32(domain))
        logits['logits_d{0}'.format(domain)] = np.moveaxis(
            np.asarray(out), -1, 1).astype(np.float32)
    np.savez(os.path.join(OUT, 'window.npz'), x=x, **logits)
    with open(os.path.join(OUT, 'net.cfg'), 'w') as f:
        f.write('[network]\n' + ''.join(
            '{0} = {1}\n'.format(k, v) for k, v in FIXTURE_NET.items()))
    os.remove(os.path.join(OUT, 'jax_latest.txt'))
    for name in sorted(os.listdir(OUT)):
        print(name, os.path.getsize(os.path.join(OUT, name)), 'bytes')


if __name__ == '__main__':
    main()
