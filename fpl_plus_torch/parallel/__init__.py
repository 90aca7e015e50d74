"""Scale-out: data-parallel training and sharded inference over ranks
(``mesh.py``) and the multi-process surface (``multihost.py``); the names
of the JAX package's ``parallel/__init__.py``."""
from fpl_plus_torch.parallel.mesh import (make_mesh, mesh_size_from_config,
                                          replicate, shard_batch,
                                          make_sharded_train_step,
                                          sharded_sliding_window)

__all__ = ['make_mesh', 'mesh_size_from_config', 'replicate', 'shard_batch',
           'make_sharded_train_step', 'sharded_sliding_window']
