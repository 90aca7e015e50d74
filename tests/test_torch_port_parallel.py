"""PyTorch port, the scale-out surface in one process: the manifest shards
and the mesh resolution against the JAX package's, the row split of a
host batch, the global-batch dropout draws, the ranks' shares of a grid,
the multihost gating, and the agent that refuses a mesh.

No process group forms here (``tests/test_torch_port_dist.py`` starts the
ranks): the draws and shares are checked with stand-in meshes that carry
only a rank and a size.
"""
import os
import types

import numpy as np
import pytest
import torch

from fpl_plus_torch.engine.infer import _padded_share
from fpl_plus_torch.models.common import group_rand, grouped_dropout
from fpl_plus_torch.parallel import mesh as port_mesh
from fpl_plus_torch.parallel import multihost
from fpl_plus_torch.parallel.mesh import (Mesh, data_parallel,
                                          mesh_size_from_config, shard_batch)

ENV = (multihost.ENV_COORDINATOR, multihost.ENV_NUM_PROCESSES,
       multihost.ENV_PROCESS_ID)


@pytest.fixture
def clean_env(monkeypatch):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


@pytest.mark.parametrize('n,hosts', [(23, 4), (5, 2), (2, 3), (7, 1)])
def test_shard_manifest_rows_matches_jax(n, hosts):
    from fpl_plus_tpu.parallel.multihost import shard_manifest_rows as jax
    for i in range(hosts):
        assert multihost.shard_manifest_rows(n, i, hosts) == jax(n, i, hosts)


# (config, stage, global devices, hosts)
MESH_TABLE = [
    ({}, 'train', 8, 1),
    ({'training': {'gpus': [0]}}, 'train', 8, 1),
    ({'training': {'gpus': [0, 1, 2]}}, 'train', 8, 1),
    ({'training': {'mesh_devices': 4, 'gpus': [0, 1]}}, 'train', 8, 1),
    ({'training': {'mesh_devices': -1}}, 'train', 8, 1),
    ({'training': {'mesh_devices': 16}}, 'train', 8, 1),
    ({'training': {'mesh_devices': 0}}, 'train', 8, 1),
    ({'training': {'mesh_devices': 4}, 'testing': {'mesh_devices': 2}},
     'test', 8, 1),
    ({'training': {'mesh_devices': 4}, 'testing': {'gpus': [0, 1]}},
     'test', 8, 1),
    ({'training': {'gpus': [0, 1]}, 'testing': {}}, 'test', 8, 1),
    ({'training': {'gpus': [0, 1, 2, 3]}, 'testing': {'gpus': [0]}},
     'test', 8, 1),
    ({'training': {'multihost': True}}, 'train', 8, 1),
    ({'training': {}}, 'train', 8, 2),
    ({'training': {'mesh_devices': -1}}, 'train', 8, 2),
    ({'training': {'mesh_devices': 8}}, 'train', 8, 2),
    ({'training': {'mesh_devices': 4}}, 'train', 8, 2),
    ({'training': {'mesh_devices': 2, 'multihost': True}}, 'test', 4, 2),
]


@pytest.mark.parametrize('config,stage,avail,hosts', MESH_TABLE)
def test_mesh_size_from_config_matches_jax(clean_env, config, stage, avail,
                                           hosts):
    """The port resolves the table as the JAX package does (same sizes,
    same clamp, same multi-host error), JAX seeing ``avail`` devices over
    ``hosts`` processes and the port ``avail / hosts`` devices on each of
    ``hosts`` hosts."""
    import jax
    import fpl_plus_tpu.parallel.multihost as jax_multihost
    from fpl_plus_tpu.parallel.mesh import mesh_size_from_config as jax_size
    clean_env.setattr(jax, 'device_count', lambda: avail)
    clean_env.setattr(jax_multihost, 'process_info', lambda: (0, hosts))
    clean_env.setattr(port_mesh, 'local_device_count',
                      lambda device_type='cuda': avail // hosts)
    clean_env.setenv(multihost.ENV_NUM_PROCESSES, str(hosts))
    clean_env.setenv(multihost.ENV_PROCESS_ID, '0')
    try:
        want = jax_size(config, stage)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            mesh_size_from_config(config, stage, 'cpu')
        assert str(got.value) == str(exc)
        return
    assert mesh_size_from_config(config, stage, 'cpu') == want


def _write_manifest(tmp_path, rows):
    from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_nifti
    geom = ImageGeometry(origin=(0., 0., 0.), spacing=(1.0, 1.0, 1.0),
                         direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
    rs = np.random.RandomState(5)
    lines = []
    for i in range(rows):
        for kind in ('img', 'lab'):
            arr = (rs.normal(size=(4, 6, 6)).astype(np.float32)
                   if kind == 'img' else np.zeros((4, 6, 6), np.int16))
            write_nifti(NiftiImage(arr, geom),
                        str(tmp_path / '{0}{1}.nii.gz'.format(kind, i)))
        lines.append('img{0}.nii.gz,lab{0}.nii.gz'.format(i))
    csv = tmp_path / 'm.csv'
    csv.write_text('image,label\n' + '\n'.join(lines) + '\n')
    return str(csv)


@pytest.mark.parametrize('shard', [(0, 2), (1, 2), (2, 3)])
def test_host_shard_rows_match_jax(tmp_path, shard):
    from fpl_plus_tpu.io.dataset import NiftyDataset as JaxDataset
    from fpl_plus_torch.io.dataset import NiftyDataset
    csv = _write_manifest(tmp_path, 5)
    jax_set = JaxDataset(str(tmp_path), csv, with_label=True,
                         host_shard=shard)
    port_set = NiftyDataset(str(tmp_path), csv, with_label=True,
                            host_shard=shard)
    assert len(port_set) == len(jax_set)
    assert [r[0] for r in port_set.rows] == list(
        jax_set.csv_items.iloc[:, 0])
    for i in range(len(port_set)):
        np.testing.assert_array_equal(port_set[i]['image'],
                                      jax_set[i]['image'])


def test_host_shard_refuses_an_empty_share(tmp_path):
    from fpl_plus_torch.io.dataset import NiftyDataset
    csv = _write_manifest(tmp_path, 2)
    with pytest.raises(ValueError, match='fewer rows than the 3 hosts'):
        NiftyDataset(str(tmp_path), csv, with_label=True, host_shard=(2, 3))


def _stand_in(rank, size, local_rank=None, local_size=None):
    return types.SimpleNamespace(
        rank=rank, size=size,
        local_rank=rank if local_rank is None else local_rank,
        local_size=size if local_size is None else local_size)


def test_shard_batch_takes_each_rank_its_rows():
    """Host ranks split the host batch into contiguous rows; nested
    microbatch lists, numbers and strings pass through."""
    batch = ({'image': torch.arange(12.).reshape(4, 3), 'n': 2},
             [np.arange(8).reshape(4, 2), 'x'])
    parts = [shard_batch(batch, _stand_in(r, 4, r % 2, 2)) for r in range(4)]
    assert torch.equal(parts[1][0]['image'], batch[0]['image'][2:])
    assert parts[3][0]['n'] == 2 and parts[3][1][1] == 'x'
    np.testing.assert_array_equal(parts[2][1][0], batch[1][0][:2])
    with pytest.raises(ValueError, match='does not split over 3 ranks'):
        shard_batch(batch, _stand_in(0, 3))


@pytest.mark.parametrize('n,size', [(10, 3), (2, 4), (6, 2), (7, 7)])
def test_shares_cover_the_grid_and_pad_the_passes(n, size):
    """Window shares partition the grid contiguously within one of each
    other; pass shares pad to a multiple of the ranks with the last
    pass."""
    shares = [Mesh.share(_stand_in(r, size), n) for r in range(size)]
    assert [i for lo, hi in shares for i in range(lo, hi)] == list(range(n))
    sizes = [hi - lo for lo, hi in shares]
    assert max(sizes) - min(sizes) <= 1
    padded = [i for r in range(size)
              for i in _padded_share(n, _stand_in(r, size))]
    assert len(padded) % size == 0 and padded[:n] == list(range(n))
    assert set(padded[n:]) <= {n - 1}


@pytest.mark.parametrize('groups', [1, 2])
def test_dropout_draws_the_global_batch_mask(groups):
    """Within a data-parallel step each rank keeps its rows of the mask
    that one process draws for the global batch, group by group; a draw of
    one value per group is the same on every rank."""
    x = torch.ones(8, 3, 2, 4, 4)
    seeds = [11, 12][:groups]

    def gens():
        return [torch.Generator().manual_seed(s) for s in seeds]

    whole = grouped_dropout(x, 0.4, gens())
    for size in (2, 4):
        rows = 8 // size
        parts = []
        for r in range(size):
            with data_parallel(_stand_in(r, size)):
                parts.append(grouped_dropout(x[:rows], 0.4, gens())
                             if groups == 1 else
                             group_rand((rows // groups, 3, 2, 4, 4),
                                        gens(), 'cpu'))
        if groups == 1:
            torch.testing.assert_close(torch.cat(parts), whole, rtol=0,
                                       atol=0)
        else:
            full = group_rand((8 // groups, 3, 2, 4, 4), gens(), 'cpu')
            torch.testing.assert_close(torch.cat(parts), full, rtol=0,
                                       atol=0)
        with data_parallel(_stand_in(1, size)):
            one = group_rand((1,), gens(), 'cpu', rows=False)
        torch.testing.assert_close(one, group_rand((1,), gens(), 'cpu'))


def test_multihost_gating(clean_env):
    """Nothing asks for a group: none forms. ``multihost = True`` without
    the coordinator raises instead of running alone; a host index outside
    the host count raises."""
    assert multihost.maybe_initialize_distributed({'training': {}},
                                                  'cpu') is False
    assert multihost.process_info() == (0, 1, 0, 1)
    assert multihost.is_primary_host()
    with pytest.raises(RuntimeError, match='FPLX_COORDINATOR'):
        multihost.maybe_initialize_distributed(
            {'training': {'multihost': True}}, 'cpu')
    clean_env.setenv(multihost.ENV_NUM_PROCESSES, '2')
    clean_env.setenv(multihost.ENV_PROCESS_ID, '2')
    with pytest.raises(ValueError, match='name no host'):
        multihost.host_layout()


def _agents():
    from fpl_plus_torch.agents.agent_cls import ClassificationAgent
    from fpl_plus_torch.agents.nll import NLLCoTeaching
    from fpl_plus_torch.agents.ssl import SSLMeanTeacher
    from fpl_plus_torch.agents.wsl import WSLEntropyMinimization
    return [SSLMeanTeacher, WSLEntropyMinimization, NLLCoTeaching,
            ClassificationAgent]


@pytest.mark.parametrize('index', range(4))
@pytest.mark.parametrize('scale', ['mesh', 'multihost'])
def test_agents_without_a_data_parallel_step_refuse_a_mesh(clean_env, index,
                                                           scale):
    """The classification agent, which has no data-parallel step, raises
    under a mesh (or a multi-process request) instead of training on one
    device; the SSL, WSL and NLL agents are built under the same request,
    to train over the mesh."""
    agent = _agents()[index]
    training = ({'mesh_devices': 2} if scale == 'mesh'
                else {'multihost': True})
    config = {'dataset': {'task_type': 'seg'}, 'network': {},
              'training': training, 'testing': {}}
    if agent.__name__ == 'ClassificationAgent':
        with pytest.raises(NotImplementedError,
                           match='ClassificationAgent has no data-parallel'):
            agent(config, 'train', 'cpu')
        return
    built = agent(config, 'train', 'cpu')
    assert built.data_parallel is True


def test_clslsr_and_paradigm_cli_refuse_a_mesh(clean_env, tmp_path):
    """The CLSLSR agent is built under a mesh request; the classification
    CLI raises before any rank starts or any log is written."""
    from fpl_plus_torch.agents.nll_clslsr import NLLCLSLSR
    from fpl_plus_torch.cli import main
    config = {'dataset': {}, 'network': {}, 'testing': {},
              'training': {'gpus': [0, 1]}}
    assert NLLCLSLSR(config, 'cpu').data_parallel is True
    cfg = tmp_path / 'cls.cfg'
    cfg.write_text('[dataset]\ntask_type = cls\n[network]\nclass_num = 2\n'
                   '[training]\nmesh_devices = 2\nckpt_save_dir = {0}\n'
                   '[testing]\nckpt_mode = 0\n'.format(tmp_path))
    with pytest.raises(NotImplementedError,
                       match='ClassificationAgent has no data-parallel'):
        main(['train', str(cfg)], device='cpu')
    assert not os.path.exists(tmp_path / 'log_train.txt')


def test_a_mesh_without_ranks_raises(clean_env):
    """A segmentation stage asking for 2 ranks in a process that joined no
    group raises: the CLI is what starts the ranks."""
    from fpl_plus_torch.agents.agent_seg import SegmentationAgent
    config = {'dataset': {}, 'network': {}, 'testing': {},
              'training': {'mesh_devices': 2}}
    agent = SegmentationAgent(config, 'test', 'cpu')
    with pytest.raises(RuntimeError, match='joined no process group'):
        agent.get_mesh()
