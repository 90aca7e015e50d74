"""Swin UNETR's fused window attention's share of its roofline (%): the
least time of its work, the larger of its bytes over the card's memory
bandwidth and its operations over the dense peak of matrix products at the
run's precision and flags (at float32 TF32 only while cuBLAS may use it),
over the summed device time of the kernel's events that start in the
slice. Per launch, the mean over one volume's launches.

The bytes come from the reference's ``work_per_window`` (q, k, v and the
output once, and the bias table), through ``ctx.work``. The operations
(QK^T and PV) do not: the harness's work carries a kernel's bytes and
launches alone, so they come from the reference's
``window_attention_flops`` for the run's window, taken here through the
context's run. The kernel's names in the trace are this file's."""
from benchmark.reference import serve

NAMES = ('window_attention_kernel',)


def read(ctx):
    t = ctx.trace
    if t is None or ctx.peaks is None:
        return None
    work = ctx.work
    if 'window_attention_bytes_per_item' not in work:
        return None
    events = [e for e in t.kernels_in_slice()
              if any(n in e['name'] for n in NAMES)]
    if not events:
        return None
    run = ctx._run
    te = run.sections['testing']
    shape = [max(s, w) for s, w in zip(run.traffic['volume_shape'],
                                       te['sliding_window_size'])]
    win = serve.grid(shape, te['sliding_window_size'],
                     te['sliding_window_stride'])[1]
    itemsize = 4 if work['precision'] == 'float32' else 2
    per_window = run.reference.work_per_window(run.net_cfg, win, itemsize)
    windows = (work['window_attention_bytes_per_item']
               / per_window['kernels']['window_attention']['bytes'])
    launches = work['window_attention_launches_per_item']
    flops = run.reference.window_attention_flops(run.net_cfg, win) \
        * windows / launches
    nbytes = work['window_attention_bytes_per_item'] / launches
    least_s = max(nbytes / ctx.peaks['hbm_bytes_per_s'],
                  flops / ctx.peak_flops('matmul'))
    return 100.0 * len(events) * least_s * 1e6 / sum(e['dur'] for e in events)
