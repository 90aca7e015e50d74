"""Hand-written Hopper kernels, each beside its plain PyTorch version
(``from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu``)."""
