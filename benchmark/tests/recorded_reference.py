"""A network reference for the harness's dispatch tests: the functions of
``reference/unet2d5_dsbn.py`` re-exported, each call appended to
``CALLS``. A test puts ``ShiftedNet`` in ``Net``'s place to see that the
judge builds the network from this module."""
import torch

from benchmark.reference import unet2d5_dsbn as base

CALLS = []


class Net(base.Net):
    def __call__(self, x, domain, train=False, generators=None):
        CALLS.append('Net')
        return super().__call__(x, domain, train, generators)


class ShiftedNet(base.Net):
    """The reference's logits with class 1 raised by 1."""

    def __call__(self, x, domain, train=False, generators=None):
        out = super().__call__(x, domain, train, generators)
        return torch.cat([out[:, :1], out[:, 1:2] + 1.0, out[:, 2:]], 1)


def make_weights(net, seed, device):
    CALLS.append('make_weights')
    return base.make_weights(net, seed, device)


def calibrate_foreground(net, weights, window, domain, share):
    CALLS.append('calibrate_foreground')
    return base.calibrate_foreground(net, weights, window, domain, share)


def work_per_window(net, window, itemsize=4):
    CALLS.append('work_per_window')
    return base.work_per_window(net, window, itemsize)
