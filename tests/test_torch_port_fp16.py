"""PyTorch port, ``precision = float16``: the aliases, the DSBN+PReLU kernel
module at f16, serving and the joint train step against the JAX package at
f16, and the port's f16 paths through the CLI and the paradigm agents.

The policy is the JAX package's (``utils/precision.py`` there): f32 master
parameters, optimizer state, DSBN statistics and checkpoints; f16 copies of
the parameters and the input feed the forward and the backward; logits
return to f32 before any loss, metric or accumulator; no loss scaling.

Inputs come from numpy seeds; JAX variables come from the port's
initialisation through the JAX package's numpy converter, so no init is
compiled. Four JAX programs are compiled in this file: the f16 sliding
window, the f16 joint step, the classifier's f16 step and the flagship
loss's gradient to f16 logits. On the CPU the port runs the plain version
of its kernel (f32 math, one rounding to f16), while JAX's unfused eval
DSBN computes its affine terms in f16: the two differ by a few f16
roundings per layer, which the tolerances below allow for.

* kernel module: the wrapper equals the plain version bit for bit; both are
  within one f16 ulp (2^-10 relative) of JAX's ``dsbn_prelu_reference``
  computed in f32 on the same f16 inputs and rounded once;
* serving: the host casts are bit-equal (values beyond +-65504 become +-inf
  in both); probabilities within 2e-2 absolute; labels (argmax) equal on at
  least 99.5% of voxels;
* joint step, 2 Adam steps at lr 1e-3: every convolution of the port's
  step sees f16 inputs and weights; losses within rtol 2e-4 (measured
  2.1e-5); the first step's gradient (JAX's: Adam's first moment / 0.1)
  within relative L2 0.15 of JAX's over all parameters (measured 0.0142)
  and 0.5 on each tensor that holds at least 1% of the gradient's norm
  (measured at most 0.096): a zero or sign-flipped gradient fails; master
  parameters and DSBN statistics f32 in both; after n steps the
  parameters within 2 x lr x n (Adam's early update is about lr x
  sign(g), and a gradient that rounds to the other sign moves a weight by
  at most 2 x lr);
* the flagship batch's loss gradient to f16 logits (4 + 4 crops of
  28 x 128 x 128): every entry under f16's smallest normal number in
  both packages; bit-equal on at least 99.9% of entries, the shares of
  zeros and subnormals within 1e-4;
* the classifier's SGD step against JAX's f16 step: every convolution and
  the head see f16 inputs and weights; the loss within rtol 2e-2, the BN
  statistics within 1e-2 of each tensor's largest value, and the gradient
  over all parameters within cosine 0.9 and relative L2 0.5 of JAX's
  (measured 0.955 and 0.302). At this size (ResNet18 on 4 images of
  32 x 32; 1 x 1 maps and batch statistics over 4 values in the last
  stage) f16 moves either package's gradient far from its own f32 one
  (relative L2: JAX 0.31, the port 0.20), and the two packages' f16
  roundings fall in different places, so the port's f32 gradient is about
  as near JAX's f16 one (0.310) as the port's f16 gradient is: these
  limits hold the f16 backward to JAX's, and the dtype check, not they,
  shows that the step runs at f16;
* one SSL, WSL and NLL method, 2 Adam steps at f16 against the same steps
  at f32 from the same weights and batches: every convolution sees f16
  inputs and weights; the losses within rtol 1e-2 (measured at most
  8.8e-4); the first step's gradient within relative L2 0.5 of f32's
  over all parameters (measured 0.060, 0.122 and 0.074);
* the CLI train and test stages and the CLSLSR driver at f16 run and write
  their outputs; the CLSLSR maps agree with f32's on at least 99% of
  voxels.
"""
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpl_plus_tpu.utils import precision as jax_precision
from fpl_plus_torch.engine.infer import Inferer
from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu, dsbn_prelu_reference
from fpl_plus_torch.utils.precision import cast_infer_module, resolve_dtype
from tests.test_torch_port_clslsr import CL_CFG, cl_workspace  # noqa: F401
from tests.test_torch_port_models import (SMALL, center_head,  # noqa: F401
                                         one_torch_thread)
from tests.test_torch_port_train_step import (CLI_CFG, _cl, make_batches,
                                              tiny_variables, torch_batches)
from tests.test_torch_port_train_units import write_train_domain

F16_ULP = 2.0 ** -10                 # one f16 ulp, relative
F16_TINY = 2.0 ** -24                # the smallest f16 subnormal
F16_NORMAL = 2.0 ** -14              # the smallest normal f16
COTANGENT_SAME = 0.999
SERVE_SW = {'sliding_window_enable': True, 'sliding_window_size': [8, 16, 16],
            'sliding_window_stride': [8, 16, 16], 'tta_mode': 1,
            'infer_unroll_max': 0}   # JAX: one scan-carried program
SERVE_VOLUME = (1, 1, 8, 32, 32)
PROB_TOL = 2e-2
LABEL_AGREE = 0.995
STEP_CFG = {'optimizer': 'Adam', 'learning_rate': 1e-3, 'momentum': 0.9,
            'weight_decay': 0.0, 'loss_type': 'DiceLoss'}
STEP_NET = dict(SMALL, dropout=[0.0] * 5)
LOSS_RTOL = 2e-4
GRAD_REL = 0.15                      # over all parameters
LEAF_GRAD_REL = 0.5                  # each tensor with 1% of the norm
LEAF_SHARE = 1e-2
SELF_LOSS_RTOL = 1e-2
SELF_GRAD_REL = 0.5
CLS_LOSS_RTOL = 2e-2
CLS_GRAD_COS = 0.9
CLS_GRAD_REL = 0.5
CLS_STATS_TOL = 1e-2
CLSLSR_AGREE = 0.99


@pytest.mark.parametrize('name', sorted(jax_precision._ALIASES, key=str))
def test_alias_resolves_as_jax(name):
    want = jax_precision.resolve_dtype(name)
    got = resolve_dtype(name)
    if want is None:
        assert got is None
    else:
        assert got == getattr(torch, jnp.dtype(want).name)


@pytest.mark.parametrize('name', ['int8', 'float64', 'half'])
def test_unknown_precision_raises_in_both(name):
    with pytest.raises(ValueError):
        jax_precision.resolve_dtype(name)
    with pytest.raises(ValueError, match='float16'):
        resolve_dtype(name)


def _tables(rs, c):
    return (rs.uniform(0.5, 2, (2, c)).astype(np.float32),
            rs.normal(size=(2, c)).astype(np.float32),
            rs.normal(size=(2, c)).astype(np.float32),
            rs.uniform(0.5, 2, (2, c)).astype(np.float32))


def test_kernel_module_at_f16_matches_jax_rounded_once():
    """f16 in and out, f16 scale and bias (``[testing] precision =
    float16``), f32 running statistics."""
    from fpl_plus_tpu.ops.pallas_fused import (
        dsbn_prelu_reference as jax_reference)
    rs = np.random.RandomState(16)
    x = torch.from_numpy(rs.normal(0, 3, (2, 8, 3, 5, 7)).astype(
        np.float32)).half()
    scale, bias, mean, var = (torch.from_numpy(t) for t in _tables(rs, 8))
    scale, bias = scale.half(), bias.half()
    alpha = torch.tensor([0.25], dtype=torch.float16)
    for d in (0, 1):
        got = dsbn_prelu(x, scale, bias, mean, var, d, alpha)
        assert got.dtype == torch.float16 and got.shape == x.shape
        assert torch.equal(got, dsbn_prelu_reference(
            x, scale, bias, mean, var, d, alpha))
        want = np.asarray(jax_reference(
            jnp.asarray(np.moveaxis(x.float().numpy(), 1, -1)),
            jnp.asarray(scale.float().numpy()),
            jnp.asarray(bias.float().numpy()), jnp.asarray(mean.numpy()),
            jnp.asarray(var.numpy()), d, jnp.float32(0.25))).astype(
                np.float16).astype(np.float32)
        want = np.moveaxis(want, -1, 1)
        err = np.abs(got.float().numpy() - want)
        assert (err <= F16_ULP * np.abs(want) + F16_TINY).all(), (
            d, float(err.max()))


CONVS = (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.ConvTranspose2d,
         torch.nn.ConvTranspose3d, torch.nn.Linear)


class conv_dtypes:
    """``with conv_dtypes(module) as seen``: the (input, weight) dtypes of
    every convolution and linear layer of ``module`` called inside."""

    def __init__(self, module):
        self.module, self.seen, self.hooks = module, set(), []

    def __enter__(self):
        def record(mod, args):
            self.seen.add((args[0].dtype, mod.weight.dtype))
        self.hooks = [m.register_forward_pre_hook(record)
                      for m in self.module.modules() if isinstance(m, CONVS)]
        return self.seen

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


def grad_gaps(got, want):
    """Relative L2 of ``got`` against ``want`` (name -> tensor) over all
    tensors, and the worst one of the tensors that hold at least
    LEAF_SHARE of ``want``'s norm."""
    g = torch.cat([got[k].double().flatten() for k in want])
    w = torch.cat([want[k].double().flatten() for k in want])
    top = float(w.norm())
    leaves = [float((got[k].double() - v.double()).norm() / v.double().norm())
              for k, v in want.items()
              if float(v.double().norm()) >= LEAF_SHARE * top]
    return float((g - w).norm()) / top, max(leaves)


class _JaxPredictor:
    def __init__(self, module):
        self.module = module

    def __call__(self, ctx, x):
        return self.module.apply(ctx[0], x, ctx[1], False)


def test_serving_at_f16_matches_jax():
    """The port's Inferer and JAX's at ``precision = float16``, the same
    weights (f16 parameters, f32 statistics) and one 8x32x32 volume under
    a window of 8x16x16 with flip TTA."""
    from fpl_plus_tpu.engine.infer import Inferer as JaxInferer
    from fpl_plus_tpu.models.registry import create_network as jax_network
    from fpl_plus_torch.models.registry import create_network
    from fpl_plus_torch.utils.convert import state_dict_from_jax
    params, stats = tiny_variables(31, SMALL)
    net = create_network(SMALL)
    net.load_state_dict(state_dict_from_jax(params, stats, SMALL),
                        strict=True)
    net.eval()
    rs = np.random.RandomState(32)
    center_head(params, net, rs.normal(size=SERVE_VOLUME).astype(
        np.float32), domain=1)
    image = rs.normal(size=SERVE_VOLUME).astype(np.float32)
    cfg = dict(SERVE_SW, output_mode='prob', precision='float16')

    # the host casts: round to nearest even; beyond f16's range, +-inf
    jax_inferer = JaxInferer(cfg)
    port_inferer = Inferer(cfg, 'cpu')
    wide = np.concatenate([image.reshape(-1)[:64], np.float32(
        [65504, 65519.99, 65520, 1e6, -1e6, 1 + 2 ** -11, 6e-8])])
    for arr in (image, wide):
        with np.errstate(over='ignore'):          # +-inf is the point
            want = jax_inferer._host_cast(arr)
        got = port_inferer._to_device(arr, []).numpy()
        assert want.dtype == got.dtype == np.float16
        np.testing.assert_array_equal(got.view(np.uint16),
                                      want.view(np.uint16))

    variables = jax_precision.cast_infer_variables(
        {'params': params, 'batch_stats': stats}, 'float16')
    want = np.asarray(jax_inferer.run(_JaxPredictor(jax_network(SMALL)),
                                      (variables, jnp.int32(1)), image))
    net16 = cast_infer_module(copy.deepcopy(net), 'float16')
    with torch.inference_mode():
        got = port_inferer.run(lambda x: net16(x, 1), image)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (1, 2) + SERVE_VOLUME[2:]
    prob_err = float(np.abs(got - want).max())
    agree = float(np.mean(got.argmax(1) == want.argmax(1)))
    labels = got.argmax(1)
    assert 0.1 < labels.mean() < 0.9          # both classes present
    assert prob_err <= PROB_TOL, prob_err
    assert agree >= LABEL_AGREE, agree


def test_joint_step_at_f16_matches_jax():
    """Two joint f16 steps (DiceLoss with pixel and image weights, Adam at
    1e-3) of the port's ``JointTrainStep`` and JAX's ``make_train_step``
    from the same f32 weights and batches."""
    from fpl_plus_tpu.engine.optim import create_optimizer as jax_optimizer
    from fpl_plus_tpu.engine.train import create_train_state, make_train_step
    from fpl_plus_tpu.losses import create_loss_calculator as jax_loss
    from fpl_plus_tpu.models.registry import create_network as jax_network
    from fpl_plus_torch.engine.optim import create_optimizer
    from fpl_plus_torch.engine.train import JointTrainStep
    from fpl_plus_torch.losses import create_loss_calculator
    from fpl_plus_torch.models.registry import create_network
    from fpl_plus_torch.utils.convert import state_dict_from_jax
    from tests.test_torch_port_train_step import adam_mu
    params, stats = tiny_variables(33, STEP_NET)
    batches = make_batches(seed=34)
    lr = STEP_CFG['learning_rate']

    optimizer = jax_optimizer(STEP_CFG, dict(STEP_CFG, last_iter=-1))
    jax_step = make_train_step(
        jax_network(STEP_NET).apply, jax_loss({'training': STEP_CFG}),
        optimizer, num_domains=2, joint=True, fpl_uda=True,
        compute_dtype=jnp.float16)
    state = create_train_state(jax.tree_util.tree_map(np.array, params),
                               jax.tree_util.tree_map(np.array, stats),
                               optimizer)
    ref_losses = []
    for i, step_batches in enumerate(batches):
        jb = tuple({k: (v if k == 'image_weight' else _cl(v))
                    for k, v in b.items()} for b in step_batches)
        state, m = jax_step(state, jb, jax.random.PRNGKey(i))
        ref_losses.append(float(m['loss']))
        if i == 0:          # Adam's first moment after one step: 0.1 x g
            ref_grads = jax.tree_util.tree_map(
                lambda mu: np.asarray(mu) / 0.1, adam_mu(state.opt_state))
    ref_params, ref_stats = jax.device_get((state.params,
                                            state.batch_stats))
    assert {np.asarray(a).dtype for a in jax.tree_util.tree_leaves(
        (ref_params, ref_stats))} == {np.dtype(np.float32)}

    net = create_network(STEP_NET)
    net.load_state_dict(state_dict_from_jax(params, stats, STEP_NET),
                        strict=True)
    net.train()
    step = JointTrainStep(net, create_loss_calculator({'training': STEP_CFG}),
                          create_optimizer(STEP_CFG, net.parameters()),
                          num_domains=2, fpl_uda=True,
                          compute_dtype=torch.float16)
    for i, step_batches in enumerate(batches):
        with conv_dtypes(net) as seen:
            m = step(torch_batches(step_batches), [None, None])
        assert seen == {(torch.float16, torch.float16)}, seen
        assert m['loss'].dtype == torch.float32
        np.testing.assert_allclose(float(m['loss']), ref_losses[i],
                                   rtol=LOSS_RTOL)
        if i == 0:
            want = state_dict_from_jax(ref_grads, ref_stats, STEP_NET)
            total, leaf = grad_gaps(
                {k: p.grad for k, p in net.named_parameters()},
                {k: want[k] for k, _ in net.named_parameters()})
            assert total <= GRAD_REL and leaf <= LEAF_GRAD_REL, (total, leaf)
    got = net.state_dict()
    assert {v.dtype for k, v in got.items()
            if not k.endswith('num_batches_tracked')} == {torch.float32}
    assert all(p.grad.dtype == torch.float32 for p in net.parameters())
    want = state_dict_from_jax(ref_params, ref_stats, STEP_NET)
    bound = 2 * lr * len(batches)
    for name, p in net.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= bound, (name, err, bound)


def _flagship_head_batch(rs, shape):
    """One domain of phase 12's flagship batch, as numpy: f16 logits,
    one-hot labels, binary pixel weights scaled per sample, image
    weights."""
    n = shape[0]
    logits = rs.normal(size=(n, 2) + shape[1:]).astype(np.float16)
    y = (rs.normal(size=shape) > 0.5).astype(np.int64)
    keep = rs.uniform(size=(n, 1) + shape[1:]) > 0.2
    scale = rs.uniform(0.5, 1.0, (n, 1, 1, 1, 1))
    return logits, {
        'ground_truth': np.moveaxis(np.eye(2, dtype=np.float32)[y], -1, 1),
        'pixel_weight': (keep * scale).astype(np.float32),
        'image_weight': rs.uniform(0.5, 1.0, n).astype(np.float32)}


def test_logits_cotangent_underflows_as_in_jax():
    """At the flagship batch (4 + 4 crops of 28 x 128 x 128, DiceLoss with
    pixel and image weights, the joint mean over the two domains) the
    gradient that reaches f16 logits through their cast to f32 is mostly
    under f16's smallest normal number: the f16 backward starts from an
    underflowed cotangent in both packages (neither scales the loss). The
    port's and JAX's f16 cotangents are equal, bit for bit, on at least
    99.9% of the entries (measured 0.9999996; every entry under 2^-14,
    30.9% exactly zero), and their shares of exact zeros and of subnormals
    agree within 1e-4 (measured 4e-7)."""
    from fpl_plus_tpu.losses import create_loss_calculator as jax_loss
    from fpl_plus_torch.losses import create_loss_calculator
    rs = np.random.RandomState(38)
    shape = (4,) + (28, 128, 128)
    doms = [_flagship_head_batch(rs, shape) for _ in range(2)]
    cfg = {'training': dict(STEP_CFG)}

    jax_calc = jax_loss(cfg)

    def jax_total(logits, batches):
        return sum(jax_calc(dict(b, prediction=l.astype(jnp.float32)))
                   for l, b in zip(logits, batches)) / 2
    want = jax.jit(jax.grad(jax_total))(
        [_cl(l) for l, _ in doms],
        [{k: v if k == 'image_weight' else _cl(v) for k, v in b.items()}
         for _, b in doms])
    want = [np.moveaxis(np.asarray(g), -1, 1) for g in want]

    calc = create_loss_calculator(cfg)
    logits = [torch.from_numpy(l).requires_grad_() for l, _ in doms]
    total = sum(calc(dict({k: torch.from_numpy(v) for k, v in b.items()},
                          prediction=l.float()))
                for l, (_, b) in zip(logits, doms)) / 2
    total.backward()
    got = [l.grad.numpy() for l in logits]

    def shares(gs):
        g = np.abs(np.concatenate([a.ravel() for a in gs]).astype(np.float32))
        return (float(np.mean(g == 0)),
                float(np.mean((g > 0) & (g < F16_NORMAL))),
                float(np.mean(g < F16_NORMAL)))
    assert all(g.dtype == np.float16 for g in want + got)
    same = float(np.mean(np.concatenate([
        (a.view(np.uint16) == b.view(np.uint16)).ravel()
        for a, b in zip(got, want)])))
    (z, sub, low), (z_j, sub_j, low_j) = shares(got), shares(want)
    assert low >= 0.9, low
    assert same >= COTANGENT_SAME, same
    assert abs(z - z_j) <= 1e-4 and abs(sub - sub_j) <= 1e-4, (
        (z, sub), (z_j, sub_j))


# -- the port's f16 paths, no JAX ------------------------------------------

def _paradigm_case(kind):
    """(agent class, config, network, batches) of one paradigm step on the
    tests' 16x16 images: MeanTeacher (a labelled and an unlabelled batch),
    WSL EntropyMinimization (scribble weights), CoTeaching (a BiNet)."""
    from fpl_plus_torch.agents import nll, ssl, wsl
    from fpl_plus_torch.models.multi_net import make_binet
    from fpl_plus_torch.models.registry import create_network
    from tests.test_torch_port_nll import nll_config
    from tests.test_torch_port_ssl import images, paradigm_config
    rs = np.random.RandomState(36)
    x, y = (torch.from_numpy(a) for a in images(rs))
    lab = {'image': x, 'label_prob': y}
    torch.manual_seed(35)
    if kind == 'ssl':
        cfg = paradigm_config('semi_supervised_learning')
        return (ssl.SSLMeanTeacher, cfg, create_network(cfg['network']),
                {'lab': lab, 'unlab': {
                    'image': torch.from_numpy(images(rs)[0])}})
    if kind == 'wsl':
        cfg = paradigm_config('weakly_supervised_learning')
        lab['pixel_weight'] = torch.from_numpy(
            (rs.uniform(size=(2, 1, 16, 16)) > 0.6).astype(np.float32))
        return (wsl.WSLEntropyMinimization, cfg,
                create_network(cfg['network']), (lab,))
    cfg = nll_config()
    return nll.NLLCoTeaching, cfg, make_binet(cfg['network']), (lab,)


def _f16_tracks_f32(run, module):
    """``run(precision, module)`` -> (losses, first-step gradients by
    name) of a copy of ``module`` at that precision. At f16 every
    convolution sees f16 inputs and weights; the f16 losses finite and
    within ``SELF_LOSS_RTOL`` of the f32 ones, the first step's gradient
    within ``SELF_GRAD_REL`` of f32's over all parameters, and the state's
    dtypes unchanged."""
    out = {}
    for precision in ('float32', 'float16'):
        net = copy.deepcopy(module)
        with conv_dtypes(net) as seen:
            losses, grads = run(precision, net)
        out[precision] = (np.asarray(losses, np.float64), grads,
                          net.state_dict())
        if precision == 'float16':
            assert seen == {(torch.float16, torch.float16)}, seen
    (l32, g32, sd32), (l16, g16, sd16) = out['float32'], out['float16']
    assert np.isfinite(l16).all(), l16
    np.testing.assert_allclose(l16, l32, rtol=SELF_LOSS_RTOL)
    total, _ = grad_gaps(g16, g32)
    assert total <= SELF_GRAD_REL, total
    for k, v in sd16.items():
        assert v.dtype == sd32[k].dtype, k


@pytest.mark.parametrize('kind', ['ssl', 'wsl', 'nll'])
def test_paradigm_steps_at_f16_track_f32(kind):
    """2 steps of one method of each paradigm family (Adam at 1e-3) at f16
    against the same steps at f32."""
    from fpl_plus_torch.engine.optim import create_optimizer
    agent_cls, cfg, module, batches = _paradigm_case(kind)

    def run(precision, net):
        c = copy.deepcopy(cfg)
        c['training']['precision'] = precision
        agent = agent_cls(c, 'train', 'cpu')
        agent.module = net.train()
        step = agent._build_step(create_optimizer(
            c['training'], net.parameters()), None)
        assert step.compute_dtype == resolve_dtype(precision)
        losses, grads = [], None
        for it in range(2):
            losses.append(float(step(batches, agent._step_generators(it),
                                     **agent.training_hyper(50))['loss']))
            if grads is None:
                grads = {k: p.grad.clone() for k, p in net.named_parameters()
                         if p.grad is not None}
        return losses, grads

    _f16_tracks_f32(run, module)


def test_cls_step_at_f16_matches_jax():
    """One SGD step of the classification agent's ``train_step`` at
    ``[training] precision = float16`` (ResNet18, 4 x 1 x 32 x 32, train-mode
    batch statistics, CrossEntropyLoss) against the gradient of the JAX
    agent's f16 forward (``cast_apply_fn``), one compiled program."""
    from fpl_plus_tpu.losses.cls import CrossEntropyLoss as JaxCE
    from fpl_plus_torch.agents.agent_cls import ClassificationAgent
    from fpl_plus_torch.engine.optim import create_optimizer
    from fpl_plus_torch.utils.convert import state_dict_from_cls
    from tests.test_torch_port_cls import jax_and_port, rgb
    jm, pm, params, stats = jax_and_port('resnet18', class_num=2,
                                         input_chns=1, seed=2)
    x = rgb(4, n=4, chns=1)
    labels = np.array([0, 1, 1, 0])
    apply16 = jax_precision.cast_apply_fn(jm.apply, jnp.float16)

    def loss_fn(p):
        out, upd = apply16({'params': p, 'batch_stats': stats},
                           jnp.asarray(np.moveaxis(x, 1, -1)), None, True,
                           mutable=['batch_stats'])
        return JaxCE()({'prediction': out,
                        'ground_truth': jnp.asarray(labels)}), upd
    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                    has_aux=True))(params)
    cfg = {'dataset': {'task_type': 'cls'},
           'network': {'net_type': 'resnet18', 'class_num': 2,
                       'input_chns': 1},
           'training': {'optimizer': 'SGD', 'learning_rate': 0.1,
                        'momentum': 0.0, 'weight_decay': 0.0,
                        'precision': 'float16'},
           'testing': {}}
    agent = ClassificationAgent(cfg, 'train', 'cpu')
    assert agent.train_dtype == torch.float16
    agent.module = pm.train()
    with conv_dtypes(pm) as seen:
        got_loss, out = agent.train_step(
            create_optimizer(cfg['training'], pm.parameters()),
            agent._loss_calculator(), torch.from_numpy(x),
            torch.from_numpy(labels), 0)
    assert seen == {(torch.float16, torch.float16)}, seen
    assert out.dtype == torch.float32
    np.testing.assert_allclose(float(got_loss), float(loss),
                               rtol=CLS_LOSS_RTOL)
    want = state_dict_from_cls(jax.device_get(grads), jax.device_get(
        upd['batch_stats']), 'resnet18')
    names = [k for k, _ in pm.named_parameters()]
    assert all(p.dtype == p.grad.dtype == torch.float32
               for p in pm.parameters())
    got_g = torch.cat([p.grad.double().flatten() for p in pm.parameters()])
    want_g = torch.cat([want[k].double().flatten() for k in names])
    cos = float(got_g @ want_g / (got_g.norm() * want_g.norm()))
    rel = float((got_g - want_g).norm() / want_g.norm())
    assert cos >= CLS_GRAD_COS and rel <= CLS_GRAD_REL, (cos, rel)
    for name, b in pm.named_buffers():
        if name.endswith(('running_mean', 'running_var')):
            assert b.dtype == torch.float32, name
            err = float((b - want[name]).abs().max())
            assert err <= CLS_STATS_TOL * float(want[name].abs().max()), (
                name, err)


def test_cli_train_then_test_at_f16(tmp_path, monkeypatch):
    """``cli train`` (2 joint iterations, a validation, the auto test stage)
    and then ``cli test`` with ``precision = float16`` in both sections on a
    tiny weighted workspace: finite f32 losses, f32 checkpoints (weights and
    Adam's moments), a label map per test volume, the same from both
    stages."""
    from fpl_plus_torch.cli import main as torch_main
    from fpl_plus_torch.engine import train as torch_train
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = str(tmp_path)
    rs = np.random.RandomState(37)
    for d in (0, 1):
        write_train_domain(root, d, rs)
    cfg = os.path.join(root, 'train.cfg')
    with open(cfg, 'w') as f:
        f.write(CLI_CFG.format(root=root, extra='precision = float16')
                + 'precision = float16\n')
    losses, dtypes = [], set()
    real_call = torch_train.JointTrainStep.__call__

    def recording_call(self, batches, generators):
        dtypes.add(self.compute_dtype)
        out = real_call(self, batches, generators)
        losses.append(out['loss'])
        return out

    monkeypatch.setattr(torch_train.JointTrainStep, '__call__',
                        recording_call)
    assert torch_main(['train', cfg], device='cpu') == 0
    assert dtypes == {torch.float16} and len(losses) == 2
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all()
               for t in losses)
    saved = torch.load(os.path.join(root, 'model', 'gen', 'gen_2.pt'),
                       map_location='cpu', weights_only=False)
    floats = [v for v in saved['model_state_dict'].values()
              if v.is_floating_point()]
    floats += [v for s in saved['optimizer_state_dict']['state'].values()
               for k, v in s.items() if k in ('exp_avg', 'exp_avg_sq')]
    assert floats and all(v.dtype == torch.float32 and torch.isfinite(v).all()
                          for v in floats)
    out = os.path.join(root, 'result', 'gen_d1_test')
    auto = {n: load_image_as_nd_array(os.path.join(out, n))['data_array']
            for n in sorted(os.listdir(out))}
    assert len(auto) == 3
    assert torch_main(['test', cfg], device='cpu') == 0
    for n, lab in auto.items():
        assert lab.dtype == np.uint8 and set(np.unique(lab)) <= {0, 1}
        again = load_image_as_nd_array(os.path.join(out, n))
        np.testing.assert_array_equal(again['data_array'], lab)


def test_clslsr_inference_at_f16_writes_maps(cl_workspace, monkeypatch):
    """The CLSLSR driver's inference at ``[testing] precision = float16``
    (its ``_loaded_module``) writes a {0, 255} map per train volume and the
    manifest, as at f32; the maps agree with f32's on nearly every
    voxel."""
    from fpl_plus_torch.cli import main_nll_clslsr
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = cl_workspace['port']
    maps = {}
    for precision in ('float32', 'float16'):
        cfg = os.path.join(root, precision + '.cfg')
        with open(cfg, 'w') as f:
            f.write(CL_CFG.format(root=root, conv='LabelConvertNonzero, ',
                                  train_csv='train.csv', loss='DiceLoss',
                                  loss_extra='', run='gen')
                    + 'precision = {0}\n'.format(precision))
        assert main_nll_clslsr(['test', cfg], device='cpu') == 0
        assert os.path.isfile(os.path.join(root, 'train_clslsr.csv'))
        maps[precision] = []
        for c in range(3):
            arr = load_image_as_nd_array(os.path.join(
                root, 'slsr_conf', 'case{0}.nii.gz'.format(c)))['data_array']
            assert arr.shape == (1, 6, 14, 14) and arr.dtype == np.uint8
            assert set(np.unique(arr)) <= {0, 255}
            maps[precision].append(arr)
    agree = np.mean([np.mean(a == b) for a, b in zip(maps['float32'],
                                                     maps['float16'])])
    assert agree >= CLSLSR_AGREE, agree
