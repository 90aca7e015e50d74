"""How far one f32 joint train step of the PyTorch port is from exact.

    python tools/torch_train_step_precision.py      # from the checkout's root;
                                                    # needs one card

The full-width UNet2D5_dsbn of ``chip_smoke.py`` (dropout 0, its seeded
weights and one [28,128,128] crop per domain) takes one joint step
(``fpl_plus_torch.engine.train.JointTrainStep``) on the CPU in float64 (the
reference), on the CPU in f32, and on the card in f32 with TF32 off (with
cuDNN's default algorithms and with ``cudnn.deterministic``). For every
parameter it prints the max abs error of the gradient against the float64
one, over that tensor's max |g| and over the network's max |g|, and for the
DSBN running statistics the max abs error over the tensor's max; the worst
of each run last. ``chip_smoke.py`` phase 11 takes its gradient tolerance
from these numbers. Takes about a minute (the float64 step ~30 s).
"""
import copy
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from fpl_plus_torch.models.registry import create_network  # noqa: E402


def run(net, batches, device, dtype=torch.float32):
    """One step of a copy of ``net``: its gradients and running statistics
    as float64 CPU tensors."""
    model = copy.deepcopy(net).to(device=device, dtype=dtype)
    b = [{k: v.to(device=device, dtype=dtype) for k, v in x.items()}
         for x in batches]
    t0 = time.time()
    m = cs.make_step(model)(b, [None, None])
    if device.type == 'cuda':
        torch.cuda.synchronize()
    print(device, dtype, 'step s', time.time() - t0, 'loss', float(m['loss']))
    return ({k: p.grad.double().cpu() for k, p in model.named_parameters()},
            {k: v.double().cpu() for k, v in model.state_dict().items()
             if 'running' in k})


def main():
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0))
    net = create_network(dict(cs.NET_CFG, dropout=[0.0] * 5))
    cs.init_random_(net, cs.SEED + 4)
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    batches = [cs.train_inputs(gen, 1, 'cpu') for _ in range(2)]
    ref_g, ref_s = run(net, batches, torch.device('cpu'), torch.float64)
    results = {'cpu32': run(net, batches, torch.device('cpu')),
               'card': run(net, batches, dev)}
    torch.backends.cudnn.deterministic = True
    results['card_det'] = run(net, batches, dev)
    torch.backends.cudnn.deterministic = False
    top = max(float(g.abs().max()) for g in ref_g.values())
    print('network max |g|', top)
    print('%-40s %10s' % ('tensor', 'gmax') + ''.join(
        '%12s %10s' % (k + ' err/gmax', 'err/top') for k in results))
    worst = {k: 0.0 for k in results}
    for name, g in ref_g.items():
        gmax = float(g.abs().max())
        row = '%-40s %10.3g' % (name, gmax)
        for k, (grads, _) in results.items():
            err = float((grads[name] - g).abs().max())
            row += '%12.3g %10.3g' % (err / max(gmax, 1e-30), err / top)
            worst[k] = max(worst[k], err / top)
        print(row)
    print('worst err/top', worst)
    for k, (_, stats) in results.items():
        e = max(float((stats[n] - v).abs().max() / (v.abs().max() + 1e-12))
                for n, v in ref_s.items())
        print(k, 'running stats max err / tensor max', e)
    return 0


if __name__ == '__main__':
    sys.exit(main())
