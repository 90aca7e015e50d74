"""The eval DSBN+PReLU's share of its roofline (%): the least time of its
work, bytes over the card's memory bandwidth, over the summed device time
of the kernel's events that start in the slice. The bytes are counted
from the function, not from the kernel: each input element read once and
each output written once, at the activation shapes of the cell's forwards
(``reference/unet2d5_dsbn.py`` ``work_per_window``), per launch the mean
over one volume's launches. The kernel's names are in ``kernels.json``."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.peaks is None:
        return None
    work = ctx.work
    if 'dsbn_bytes_per_item' not in work:
        return None
    names = ctx.kernels['dsbn_prelu']['names']
    events = [e for e in t.kernels_in_slice()
              if any(n in e['name'] for n in names)]
    if not events:
        return None
    per_launch = work['dsbn_bytes_per_item'] / work['dsbn_launches_per_item']
    least_us = len(events) * per_launch / ctx.peaks['hbm_bytes_per_s'] * 1e6
    return 100.0 * least_us / sum(e['dur'] for e in events)
