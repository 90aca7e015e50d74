"""Classification networks: ResNet18, VGG16 and MobileNetV2 (reference
PyMIC/pymic/net/cls/torch_pretrained_net.py:24-168, the JAX package's
``models/cls_nets.py``), written by hand with torchvision's module names,
so that a torchvision ``.pth`` loads with ``load_state_dict``.

As in the JAX package: torchvision's topologies (stride-2 convolutions
padded symmetrically; VGG16's adaptive 7x7 average pool before a
classifier of width ``fc_width``, 4096 by default; the flatten in
torchvision's channel-major order, which the weight bridge maps the JAX
package's channels-last flatten onto), a fresh ``class_num`` head, and a
first convolution of ``input_chns`` inputs. ``update_mode = 'last'``
freezing, which the JAX module's docstring names, is not implemented there
either.

``forward(x, dropout_generators=None)`` takes ``[N, C, H, W]``; the
dropout before VGG16's and MobileNetV2's heads draws from the given
``torch.Generator`` s (``models/common.py`` ``grouped_dropout``; none: no
dropout, as in eval). Batch normalisation computes in f32 whatever the
input's dtype and returns that dtype (the JAX package's ``BatchNorm``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fpl_plus_torch.models.common import grouped_dropout


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with its arithmetic in f32 (a bf16 input and bf16
    affine terms are promoted, the output cast back)."""

    def forward(self, x):
        if self.training:
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight.float(), self.bias.float(),
                            self.training, self.momentum, self.eps
                            ).to(x.dtype)


def _conv_bn(cin, cout, k, stride, groups=1):
    """torchvision's ``Conv2dNormActivation`` layout: ``.0`` conv, ``.1``
    batch norm (the ReLU6 is applied by the caller)."""
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, (k - 1) // 2,
                                   groups=groups, bias=False),
                         BatchNorm2d(cout))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                BatchNorm2d(cout))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet18(nn.Module):
    def __init__(self, class_num: int, input_chns: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(input_chns, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for i, (cout, stride) in enumerate([(64, 1), (128, 2), (256, 2),
                                            (512, 2)], 1):
            setattr(self, 'layer{0}'.format(i), nn.Sequential(
                BasicBlock(cin, cout, stride), BasicBlock(cout, cout, 1)))
            cin = cout
        self.fc = nn.Linear(512, class_num)

    def forward(self, x, dropout_generators=None):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, 'layer{0}'.format(i))(x)
        return self.fc(x.mean((2, 3)))


VGG16_CFG = (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
             512, 512, 512, 'M', 512, 512, 512, 'M')


class VGG16(nn.Module):
    def __init__(self, class_num: int, input_chns: int = 3,
                 fc_width: int = 4096):
        super().__init__()
        layers, cin = [], input_chns
        for v in VGG16_CFG:
            if v == 'M':
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, 1, 1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, fc_width), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(fc_width, fc_width), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(fc_width, class_num))

    def forward(self, x, dropout_generators=None):
        x = F.adaptive_avg_pool2d(self.features(x), (7, 7)).flatten(1)
        x = grouped_dropout(F.relu(self.classifier[0](x)), 0.5,
                            dropout_generators)
        x = grouped_dropout(F.relu(self.classifier[3](x)), 0.5,
                            dropout_generators)
        return self.classifier[6](x)


class InvertedResidual(nn.Module):
    def __init__(self, cin, cout, stride, expand):
        super().__init__()
        hidden = cin * expand
        self.use_res = stride == 1 and cin == cout
        layers = [] if expand == 1 else [_conv_bn(cin, hidden, 1, 1)]
        layers += [_conv_bn(hidden, hidden, 3, stride, groups=hidden),
                   nn.Conv2d(hidden, cout, 1, bias=False), BatchNorm2d(cout)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        y = x
        for block in self.conv[:-2]:
            y = F.relu6(block(y))
        y = self.conv[-1](self.conv[-2](y))
        return y + x if self.use_res else y


MBV2_SETTINGS = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                 (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


class MobileNetV2(nn.Module):
    def __init__(self, class_num: int, input_chns: int = 3):
        super().__init__()
        layers, cin = [_conv_bn(input_chns, 32, 3, 2)], 32
        for t, c, n, s in MBV2_SETTINGS:
            for b in range(n):
                layers.append(InvertedResidual(cin, c, s if b == 0 else 1, t))
                cin = c
        layers.append(_conv_bn(320, 1280, 1, 1))
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(nn.Dropout(0.2),
                                        nn.Linear(1280, class_num))

    def forward(self, x, dropout_generators=None):
        x = F.relu6(self.features[0](x))
        for block in self.features[1:-1]:
            x = block(x)
        x = F.relu6(self.features[-1](x)).mean((2, 3))
        return self.classifier[1](grouped_dropout(x, 0.2,
                                                  dropout_generators))


def _build(cls):
    def build(cfg):
        return cls(class_num=cfg['class_num'],
                   input_chns=cfg.get('input_chns', 3))
    return build


TorchClsNetDict = {
    'resnet18': _build(ResNet18),
    'vgg16': _build(VGG16),
    'mobilenetv2': _build(MobileNetV2),
}

# the first convolution and the head of each net: left fresh by a
# pretrained load (the head always, the first convolution when
# input_chns != 3), as the reference replaces them
FIRST_CONV = {'resnet18': 'conv1.', 'vgg16': 'features.0.',
              'mobilenetv2': 'features.0.0.'}
HEAD = {'resnet18': 'fc.', 'vgg16': 'classifier.6.',
        'mobilenetv2': 'classifier.1.'}


def load_pretrained(module: nn.Module, net_type: str, pth_path: str,
                    input_chns: int = 3) -> int:
    """Load a torchvision ``.pth`` state dict (or a dict with
    ``state_dict``) into ``module``'s backbone: every tensor but the head
    and, when ``input_chns != 3``, the first convolution. Nothing is
    downloaded. Raises on a missing backbone tensor or a shape mismatch;
    returns the count loaded."""
    raw = torch.load(pth_path, map_location='cpu', weights_only=True)
    if isinstance(raw, dict) and 'state_dict' in raw:
        raw = raw['state_dict']
    skip = (HEAD[net_type],) + ((FIRST_CONV[net_type],)
                                if input_chns != 3 else ())
    own = module.state_dict()
    # a batch-norm update counter absent from the file stays as it is
    keep = {k: v for k, v in own.items() if not k.startswith(skip)
            and (k in raw or not k.endswith('num_batches_tracked'))}
    missing = sorted(k for k in keep if k not in raw)
    if missing:
        raise KeyError('pretrained {0} lacks {1}'.format(pth_path,
                                                         missing[:5]))
    for k, v in keep.items():
        if tuple(raw[k].shape) != tuple(v.shape):
            raise ValueError('shape mismatch at {0}: {1} vs {2}'.format(
                k, tuple(v.shape), tuple(raw[k].shape)))
    module.load_state_dict({k: raw[k] for k in keep}, strict=False)
    return len(keep)
