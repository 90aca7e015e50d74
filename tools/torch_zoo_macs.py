"""Reckon the network zoo's work and memory at chip_smoke.py's shapes,
without a card and without computing: each net runs on PyTorch's ``meta``
device, so only shapes flow.

    python tools/torch_zoo_macs.py

Per net (phase 18's full width, 8 windows of [28,128,128] for the 2D nets
and [32,128,128] for the 3D ones) it prints:

* GMAC per window forward, counted as ``chip_smoke.counting_macs`` counts;
* ms of the 8-window eval forward at 77 TFLOP/s, the rate the flagship's
  TF32 convolutions reached on an H100 (PERF.md);
* an eval peak-memory reckoning: parameters + input + the block outputs the
  forward keeps for its skip connections + 3 x its largest activation;
* a train-step reckoning for phase 19 (4 crops): 3 x the forward's MACs at
  77 TFLOP/s over a 0.6 convolution share of the step (the flagship step's
  measured split), and memory of every leaf module's output at 4 crops
  (the activations a backward keeps) + 4 x the parameters (weights,
  gradients, Adam's two moments).

These are predictions to hold the chip run against, not measurements.
"""
import os
import re
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

RATE = 77e12
CONV_SHARE = 0.6
# block outputs a forward keeps until a decoder level reads them
SKIP = re.compile(r'(encoder\.)?(in_conv|down\d|enc\d|x\d\d)$')


def reckon(tag):
    with torch.device('meta'):
        net, _, window = cs.zoo_net(tag, 0)
    net.eval()
    x = torch.empty((cs.BATCH, 1) + tuple(window), device='meta')
    outs, skips = [], []

    def record(name):
        def hook(mod, args, out):
            for o in cs.as_list(out):
                nbytes = o.numel() * o.element_size()
                if not list(mod.children()):
                    outs.append(nbytes)
                if SKIP.match(name):
                    skips.append(nbytes)
        return hook

    hooks = [m.register_forward_hook(record(n))
             for n, m in net.named_modules() if n]
    with torch.no_grad(), cs.counting_macs(net) as macs:
        net(x)
    for h in hooks:
        h.remove()
    params = sum(p.numel() * 4 for p in net.parameters())
    gib = 2.0 ** 30
    eval_peak = (params + x.numel() * 4 + sum(skips) + 3 * max(outs)) / gib
    fwd_ms = 2 * macs[0] / RATE * 1e3
    train_ms = 3 * fwd_ms * cs.TRAIN_BATCH / cs.BATCH / CONV_SHARE
    train_peak = (sum(outs) * cs.TRAIN_BATCH / cs.BATCH + 4 * params) / gib
    return macs[0] / cs.BATCH / 1e9, fwd_ms, eval_peak, train_ms, train_peak


def main():
    print('{0:18s} {1:>10s} {2:>9s} {3:>9s} {4:>9s} {5:>9s}'.format(
        'net', 'GMAC/win', 'fwd ms', 'fwd GiB', 'step ms', 'step GiB'))
    for tag in cs.ZOO:
        gmac, fwd_ms, eval_peak, train_ms, train_peak = reckon(tag)
        print('{0:18s} {1:10.3f} {2:9.2f} {3:9.2f} {4:9.2f} {5:9.2f}'.format(
            tag, gmac, fwd_ms, eval_peak, train_ms, train_peak))
    return 0


if __name__ == '__main__':
    sys.exit(main())
