"""Where the time of a zoo network's eval forward goes, on one card.

    python tools/torch_zoo_profile.py [tag ...]   # from the checkout's
                                                  # root; needs one card

For each ``chip_smoke.py`` zoo tag (default: UNet2D, UNet3D) the 8-window
eval forward of phase 18 (full width, random weights, f32 with TF32 as
PyTorch defaults) runs 3 times to warm up, then ``torch.profiler`` records 3
forwards. It prints the wall time per forward (host clock, synchronised),
the device time summed over the CUDA kernels, the device's idle share, the
kernel time per category (``tools/torch_train_step_profile.py``'s) and the
12 kernels that take the most device time. Then the same forward timed by
CUDA events with ``torch.backends.cudnn.benchmark`` on, which lets cuDNN
time its algorithms instead of picking by heuristics.
"""
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from tools.torch_train_step_profile import category, device_time_us  # noqa

REPS = 3


def event_ms(fn, reps=5):
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return float(np.median(ms))


def profile_tag(tag, dev):
    net, _, window = cs.zoo_net(tag, cs.SEED)
    net = net.to(dev).eval()
    x = torch.randn((cs.BATCH, 1) + tuple(window), device=dev)
    with torch.inference_mode():
        for _ in range(3):
            net(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for _ in range(REPS):
                net(x)
            torch.cuda.synchronize()
            wall = (time.time() - t0) / REPS * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            kernels = [e for e in prof.key_averages()
                       if device_time_us(e) > 0]
        total = sum(device_time_us(e) for e in kernels) / REPS / 1e3
        print('{0}: 8 windows of {1}: wall {2:.2f} ms per forward, kernels '
              '{3:.2f} ms, device idle share {4:.1%}'.format(
                  tag, window, wall, total, 1 - total / wall))
        cats = {}
        for e in kernels:
            c = category(e.key)
            cats[c] = cats.get(c, 0.0) + device_time_us(e) / REPS / 1e3
        for c, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
            print('  {0:18s} {1:8.2f} ms ({2:.1%})'.format(
                c, ms, ms / max(total, 1e-9)))
        for e in sorted(kernels, key=device_time_us, reverse=True)[:12]:
            print('  {0:9.3f} ms {1:5d}x  {2}'.format(
                device_time_us(e) / REPS / 1e3, e.count // REPS,
                e.key[:110]))
        torch.backends.cudnn.benchmark = True
        try:
            for _ in range(2):
                net(x)
            bench = event_ms(lambda: net(x))
        finally:
            torch.backends.cudnn.benchmark = False
        default = event_ms(lambda: net(x))
    print('{0}: CUDA events, median of 5: heuristic algorithms {1:.2f} ms, '
          'cudnn.benchmark {2:.2f} ms'.format(tag, default, bench))


def main():
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    print(torch.cuda.get_device_name(0), torch.__version__)
    for tag in sys.argv[1:] or ['UNet2D', 'UNet3D']:
        profile_tag(tag, dev)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
