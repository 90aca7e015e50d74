"""Where the time of the PyTorch port's joint train step goes, on one card.

    python tools/torch_train_step_profile.py    # from the checkout's root;
                                                # needs one card

The flagship step of ``chip_smoke.py`` phase 12 (full-width UNet2D5_dsbn
with its dropout, batch 4+4 crops of [28,128,128], ``train_fpl_uda``
DiceLoss with pixel and image weights, Adam) at f32 (TF32, PyTorch's
default) and bf16: 3 warm-up steps, then ``torch.profiler`` over 3 steps.
It prints the wall time per step (host clock, synchronised), the device
time per step summed over the CUDA kernels, the device's idle share
(1 - kernel time / wall time: one stream, so kernels do not overlap), the
kernel time per category of kernel name, and the 15 kernels that take the
most device time.
"""
import copy
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from fpl_plus_torch.models.registry import create_network  # noqa: E402
from fpl_plus_torch.utils.precision import resolve_dtype  # noqa: E402

STEPS = 3
# substrings of kernel names, first match wins
CATEGORIES = (
    ('batch norm', ('batch_norm', 'bn_fw', 'bn_bw', 'batchnorm',
                    'welford')),
    ('convolution', ('conv', 'xmma', 'gemm', 'wgrad', 'dgrad', 'fprop',
                     'cutlass', 'sm90', 'sm80', 'winograd', 'fft',
                     'implicit')),
    ('optimizer', ('adam', 'multi_tensor')),
    ('dropout / random', ('philox', 'uniform', 'bernoulli', 'random')),
    ('copy / cast', ('copy', 'memcpy', 'memset', 'cast', 'fill')),
    ('reduction', ('reduce',)),
    ('elementwise', ('elementwise', 'vectorized', 'unrolled', 'where',
                     'prelu', 'softmax', 'cat', 'index')),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return 'other'


def device_time_us(evt) -> float:
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main():
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    print(torch.cuda.get_device_name(0), torch.__version__)
    net = create_network(cs.NET_CFG)
    cs.init_random_(net, cs.SEED)
    gen = torch.Generator().manual_seed(cs.SEED + 6)
    batches = [cs.train_inputs(gen, cs.TRAIN_BATCH, dev) for _ in range(2)]
    for precision in ('float32', 'bfloat16'):
        step = cs.make_step(copy.deepcopy(net).to(dev),
                            resolve_dtype(precision))
        gens = [torch.Generator(dev).manual_seed(i) for i in range(64)]

        def one(i):
            step(batches, [[gens[2 * i]], [gens[2 * i + 1]]])

        for i in range(3):
            one(i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for i in range(3, 3 + STEPS):
                one(i)
            torch.cuda.synchronize()
            wall = (time.time() - t0) / STEPS * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:      # older builds list kernels under CPU events
            kernels = [e for e in prof.key_averages()
                       if device_time_us(e) > 0]
        total = sum(device_time_us(e) for e in kernels) / STEPS / 1e3
        print('{0}: wall {1:.2f} ms per step, kernels {2:.2f} ms per step, '
              'device idle share {3:.1%}'.format(precision, wall, total,
                                                 1 - total / wall))
        cats = {}
        for e in kernels:
            c = category(e.key)
            cats[c] = cats.get(c, 0.0) + device_time_us(e) / STEPS / 1e3
        for c, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
            print('  {0:18s} {1:8.2f} ms ({2:.1%})'.format(
                c, ms, ms / max(total, 1e-9)))
        for e in sorted(kernels, key=device_time_us, reverse=True)[:15]:
            print('  {0:9.3f} ms {1:5d}x  {2}'.format(
                device_time_us(e) / STEPS / 1e3, e.count // STEPS,
                e.key[:110]))
        del step
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
