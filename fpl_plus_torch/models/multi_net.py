"""Peer networks: BiNet and TriNet (reference BiNet in
net_run_ssl/ssl_cps.py:15-29, also used by DMPLS, CoTeaching and DAST;
TriNet in net_run_nll/nll_trinet.py:21-37; the JAX package's
``models/multi_net.py``).

``MultiNet`` holds N peers of one registry network, ``nets.0`` ..
``nets.{N-1}``, each initialised on its own. In train mode ``forward``
returns the tuple of the peers' outputs; in eval mode the average of their
primary heads, divided by N (the reference BiNet divides by 3, a typo the
JAX package does not keep). The peers run one after the other on the same
input and the same ``dropout_generators``, so the second peer draws its
masks after the first. ``state_dict_from_multinet`` in
``utils/convert.py`` bridges the JAX package's variables.
"""
from __future__ import annotations

from torch import nn

from fpl_plus_torch.models.registry import create_network


def _primary(out):
    return out[0] if isinstance(out, (list, tuple)) else out


class MultiNet(nn.Module):
    def __init__(self, net_cfg: dict, n_nets: int = 2):
        super().__init__()
        self.nets = nn.ModuleList(create_network(net_cfg)
                                  for _ in range(n_nets))

    @property
    def draws_in_train(self) -> bool:
        """A peer that draws in train mode even at dropout 0 (CCT) makes
        the pair draw too."""
        return getattr(self.nets[0], 'draws_in_train', False)

    def forward(self, x, domain_label: int = 0, dropout_generators=None):
        outs = [net(x, domain_label, dropout_generators) for net in self.nets]
        if self.training:
            return tuple(outs)
        total = _primary(outs[0])
        for out in outs[1:]:
            total = total + _primary(out)
        return total / len(outs)


def make_binet(net_cfg: dict) -> MultiNet:
    return MultiNet(net_cfg, 2)


def make_trinet(net_cfg: dict) -> MultiNet:
    return MultiNet(net_cfg, 3)
