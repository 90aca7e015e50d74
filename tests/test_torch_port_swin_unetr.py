"""PyTorch port, Swin UNETR (``models/swin_unetr.py``) and its window
attention (``ops/window_attention.py``) on the CPU.

The network is held to the benchmark's plain reference of it
(``benchmark/reference/swin_unetr.py``, loaded by path as the harness loads
it) on the reference's seeded weights; the attention's plain version to a
naive masked softmax attention written out here. The Triton kernel runs
only on the card (``chip_smoke.py``).
"""
import importlib.util
import itertools
import pathlib

import numpy as np
import pytest
import torch

from fpl_plus_torch.models.registry import (NETS_3D, create_network,
                                            param_count)
from fpl_plus_torch.models.swin_unetr import shift_regions
from fpl_plus_torch.ops.window_attention import (relative_position_index,
                                                 window_attention,
                                                 window_attention_reference)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = {'net_type': 'SwinUNETR', 'in_chns': 1, 'class_num': 2,
        'feature_size': 12, 'depths': [2, 2, 2, 2],
        'num_heads': [3, 6, 12, 24]}
PUBLISHED = dict(TINY, feature_size=48)
# the count of the published widths at 2 classes (62,187,296 at BTCV's 14);
# the relative-index buffers are not parameters
PUBLISHED_PARAMS = 62186708
# [32, 64, 64]: stage grids [16,32,32] and [8,16,16] padded to whole 7^3
# windows and shifted; [4,8,8] with its depth window clipped to 4 and no
# depth shift; [2,4,4] clipped on every axis, so never shifted
INPUT = (1, 1, 32, 64, 64)
# f32 on both sides, the same operations in other orders (instance norm's
# mean and variance, the attention's products) through ~40 layers:
# measured 2e-5 on logits of magnitude up to 8
LOGIT_TOL = 2e-4


def reference():
    spec = importlib.util.spec_from_file_location(
        'swin_unetr_reference', ROOT / 'benchmark' / 'reference'
        / 'swin_unetr.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = reference()


@pytest.fixture(autouse=True, scope='module')
def two_torch_threads():
    """A small pool, not a full one beside the other test workers: the
    window attention's softmax over 26 M scores a block sets this file's
    time (about 10 s on one thread, 8 on two)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def tiny_weights():
    return REF.make_weights(TINY, 20261018, 'cpu')


@pytest.fixture(scope='module')
def published():
    return create_network(PUBLISHED)


def test_eval_forward_matches_the_plain_reference(tiny_weights):
    # the seeded weights make the attention selective (scores spread by
    # about 3), where a wrong bias row or region shows
    weights = tiny_weights
    net = create_network(TINY)
    net.load_state_dict(weights, strict=True)
    x = torch.from_numpy(np.random.RandomState(3).normal(
        size=INPUT).astype(np.float32))
    with torch.inference_mode():
        got = net.eval()(x, 1)
        want = REF.Net(TINY, weights)(x, 1)
    assert got.shape == (1, 2) + INPUT[2:]
    torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_TOL)


def test_an_input_off_the_multiple_is_padded_and_cropped(tiny_weights):
    # [8, 16, 16] runs as [32, 32, 32], whose deepest stage is one voxel
    net = create_network(TINY)
    net.load_state_dict(tiny_weights, strict=True)
    x = torch.from_numpy(np.random.RandomState(4).normal(
        size=(1, 1, 8, 16, 16)).astype(np.float32))
    with torch.inference_mode():
        got = net.eval()(x)
        want = REF.Net(TINY, tiny_weights)(x)
    assert got.shape == (1, 2, 8, 16, 16)
    torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_TOL)


def test_the_registry_builds_the_published_widths(published):
    net = published
    assert param_count(net) == PUBLISHED_PARAMS
    # BTCV's 14 classes change the head alone
    assert param_count(net) - param_count(net.out) + 48 * 14 + 14 \
        == 62187296
    assert 'SwinUNETR' in NETS_3D
    blocks = [m for m in net.modules()
              if type(m).__name__ == 'SwinTransformerBlock']
    assert [b.attn.num_heads for b in blocks] == [3, 3, 6, 6, 12, 12, 24, 24]
    assert [b.shift for b in blocks] == [(0, 0, 0), (3, 3, 3)] * 4


def test_the_seeded_weights_load_into_the_program(published, tiny_weights):
    """Every name and shape of the reference's weights at the published
    widths is the program's (without drawing 62 M values), and the seeded
    weights load with ``strict=True``; the relative-index buffers are
    MONAI's."""
    want = {k: tuple(v.shape) for k, v in published.state_dict().items()}
    assert {name: shape for name, shape, _ in REF.param_spec(PUBLISHED)} \
        == want
    net = create_network(TINY)
    net.load_state_dict(tiny_weights, strict=True)
    for name, buf in net.named_buffers():
        torch.testing.assert_close(buf, relative_position_index((7, 7, 7)),
                                   rtol=0, atol=0, msg=name)
        torch.testing.assert_close(buf, REF.relative_index(), rtol=0,
                                   atol=0)


def naive_attention(qkv, table, heads, window, regions):
    """Softmax attention of each (window, head), its scores written out:
    the bias of pair (i, j) from the offsets of i and j in the 7^3 window,
    -100 between tokens of different regions."""
    bw, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    q, k, v = qkv.double().reshape(bw, n, 3, heads, hd).unbind(2)
    pos = list(itertools.product(*[range(w) for w in window]))[:n]
    span = [2 * w - 1 for w in window]
    rows = [[((a[0] - b[0] + window[0] - 1) * span[1]
              + (a[1] - b[1] + window[1] - 1)) * span[2]
             + (a[2] - b[2] + window[2] - 1) for b in pos] for a in pos]
    bias = table.double()[torch.tensor(rows)]                # [n, n, heads]
    out = torch.empty(bw, n, heads, hd, dtype=torch.float64)
    for w in range(bw):
        for h in range(heads):
            s = q[w, :, h] @ k[w, :, h].T / hd ** 0.5 + bias[:, :, h]
            if regions is not None:
                r = regions[w % regions.shape[0]]
                s = s - 100.0 * (r[:, None] != r[None, :]).double()
            out[w, :, h] = torch.softmax(s, -1) @ v[w, :, h]
    return out.reshape(bw, n, c)


@pytest.mark.parametrize('n, shifted', [(98, True), (196, False)])
def test_the_plain_attention_is_masked_softmax_attention(n, shifted):
    gen = torch.Generator().manual_seed(n)
    heads, hd, nw = 2, 4, 3
    qkv = torch.randn(2 * nw, n, 3 * heads * hd, generator=gen) * 2
    table = torch.randn(13 ** 3, heads, generator=gen)
    regions = (torch.randint(0, 3, (nw, n), generator=gen)
               if shifted else None)
    got = window_attention(qkv, table, heads, (7, 7, 7), regions)
    want = naive_attention(qkv, table, heads, (7, 7, 7), regions)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def test_the_kernels_relative_index_is_monais():
    """The kernel's index of a pair of tokens, a token's key (its offsets
    in the window, weighted by the table's strides) less the other's plus
    a constant, against MONAI's buffer, for clipped windows too."""
    window = (7, 7, 7)
    t1, t2 = 13, 13
    tok = torch.arange(343)
    key = (tok // 49) * t1 * t2 + ((tok // 7) % 7) * t2 + tok % 7
    rel = key[:, None] - key[None, :] + 6 * t1 * t2 + 6 * t2 + 6
    torch.testing.assert_close(rel, relative_position_index(window),
                               rtol=0, atol=0)


def test_the_shift_regions_are_monais_mask():
    for dims, win, shift in (((21, 35, 35), (7, 7, 7), (3, 3, 3)),
                             ((4, 21, 21), (4, 7, 7), (0, 3, 3))):
        r = shift_regions(dims, win, shift)
        mask = REF.compute_mask(dims, win, shift, 'cpu')
        torch.testing.assert_close(
            (r[:, :, None] != r[:, None, :]).float() * -100.0, mask,
            rtol=0, atol=0)


def test_a_train_step_has_finite_gradients_and_no_kernel():
    narrow = dict(TINY, feature_size=8, num_heads=[1, 2, 4, 8])
    net = create_network(narrow)
    net.load_state_dict(REF.make_weights(narrow, 9, 'cpu'), strict=True)
    # the least input whose deepest stage keeps two voxels for instance norm
    x = torch.randn((1, 1, 32, 32, 64),
                    generator=torch.Generator().manual_seed(4))
    launches = window_attention.launches
    net.train()
    loss = net(x).square().mean()
    loss.backward()
    grads = [p.grad for p in net.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    table = net.swinViT.layers1[0].blocks[1].attn.relative_position_bias_table
    assert table.grad.abs().sum() > 0
    assert window_attention.launches == launches


def test_the_kernel_path_refuses_what_it_cannot_take():
    qkv = torch.zeros(2, 98, 36)
    with pytest.raises(ValueError, match='table'):
        window_attention_reference(qkv, torch.zeros(10, 3), 3, (7, 7, 7))
    with pytest.raises(ValueError, match='regions'):
        window_attention_reference(qkv, torch.zeros(13 ** 3, 3), 3,
                                   (7, 7, 7), torch.zeros(3, 98))
    with pytest.raises(ValueError, match='cpu or cuda'):
        window_attention(qkv.to('meta'), torch.zeros(13 ** 3, 3,
                                                     device='meta'),
                         3, (7, 7, 7))
