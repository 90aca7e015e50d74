"""Train-mode batch norm's share of the kernel time in the slice (%): the
kernels whose names match ``kernels.json`` ``batch_norm`` (cuDNN's and
PyTorch's batch-norm forward and backward kernels)."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.stage != 'train':
        return None
    pats = ctx.kernels['batch_norm']['name_parts']
    kernels = t.kernels_in_slice()
    total = sum(e['dur'] for e in kernels)
    if not total:
        return None
    bn = sum(e['dur'] for e in kernels
             if any(p in e['name'].lower() for p in pats))
    return 100.0 * bn / total
