"""PyTorch port, the loader's worker-process pool (``io/loader.py``) and the
agents' wiring of it, against the port's synchronous path and the JAX
package's pooled loader.

Per-item seeding makes the sample stream independent of the worker count,
so every comparison is bit for bit: the pooled stream at 1 and 2 workers
with the decoded-volume and transform-prefix caches on and off, epoch
iteration with ``drop_last``, the JAX package's 2-worker stream on the same
files (numpy only, no JAX compile), and the agent path with ``num_workder
= 2`` (``os.cpu_count`` patched, as ``tests/test_io.py`` does for the JAX
agent). The pool's own contract: a worker's exception and a worker's exit
raise here with the item named, ``shutdown()`` leaves no worker process,
and the workers import no torch. The probe datasets live in
``tests/loader_probe.py``, which imports neither torch nor JAX.
"""
import logging
import os
import queue
import threading

import numpy as np
import pytest

from fpl_plus_torch.agents.agent_seg import SegmentationAgent
from fpl_plus_torch.agents.nll import NLLDAST
from fpl_plus_torch.agents.ssl import SSLMeanTeacher
from fpl_plus_torch.io.dataset import NiftyDataset
from fpl_plus_torch.io.loader import DataLoader, prefetch_iter, repeat_loader
from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_nifti
from fpl_plus_torch.transforms.trans_dict import Compose, TransformDict
from tests.loader_probe import Arrays, FailingAt, InterpreterProbe

CHAIN = ['NormalizeWithMeanStd', 'Pad', 'RandomCrop', 'RandomFlip',
         'LabelToProbability']
PARAMS = {'task': 'segmentation', 'normalizewithmeanstd_channels': [0],
          'pad_output_size': [12, 40, 48], 'randomcrop_output_size': [8, 24, 24],
          'randomcrop_foreground_focus': True,
          'randomcrop_foreground_ratio': 0.7, 'randomcrop_mask_label': [1],
          'randomflip_flip_depth': False, 'randomflip_flip_height': True,
          'randomflip_flip_width': True, 'labeltoprobability_class_num': 2}


@pytest.fixture(scope='module')
def volumes(tmp_path_factory):
    """Three labelled 10x36x44 volumes and their manifest."""
    d = tmp_path_factory.mktemp('pool')
    rs = np.random.RandomState(5)
    geom = ImageGeometry(origin=(0., 0., 0.), spacing=(0.5, 0.5, 1.5),
                         direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
    rows = []
    for i in range(3):
        vol = rs.normal(100., 30., size=(10, 36, 44)).astype(np.float32)
        lab = np.zeros((10, 36, 44), np.int16)
        lab[3:7, 8 + i:20, 12:30 - i] = 1
        write_nifti(NiftiImage(vol, geom), str(d / 'img{0}.nii.gz'.format(i)))
        write_nifti(NiftiImage(lab, geom), str(d / 'lab{0}.nii.gz'.format(i)))
        rows.append('img{0}.nii.gz,lab{0}.nii.gz\n'.format(i))
    (d / 'm.csv').write_text('image,label\n' + ''.join(rows))
    return d


def port_loader(volumes, workers, cache, batch_size=2, drop_last=False):
    ds = NiftyDataset(str(volumes), str(volumes / 'm.csv'), with_label=True,
                      transform=Compose([TransformDict[n](PARAMS)
                                         for n in CHAIN]),
                      cache_bytes=(1 << 30) if cache else 0)
    return DataLoader(ds, batch_size=batch_size, shuffle=True,
                      num_workers=workers, seed=13, drop_last=drop_last)


def assert_batches_equal(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        for key in a:
            if isinstance(a[key], np.ndarray):
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            else:
                assert a[key] == b[key], key


def streamed(loader, n=5):
    stream = loader.stream()
    try:
        return [next(stream) for _ in range(n)]
    finally:
        loader.shutdown()


@pytest.mark.parametrize('workers,cache', [(1, True), (1, False), (2, True),
                                           (2, False)])
def test_pool_stream_matches_sync(volumes, workers, cache):
    """5 batches of 2 over 3 items: the stream wraps three epochs. (The
    prefix cache leaves its crop stash in the samples, so each pool is held
    against the synchronous path with the same caches.)"""
    want = streamed(port_loader(volumes, 0, cache))
    assert_batches_equal(want, streamed(port_loader(volumes, workers, cache)))


@pytest.mark.parametrize('workers', [1, 2])
def test_pool_epochs_with_drop_last_match_sync(volumes, workers):
    """Two epochs of 3 items in batches of 2: one batch each, the short
    one dropped."""
    def epochs(loader):
        try:
            return [b for _ in range(2) for b in loader]
        finally:
            loader.shutdown()
    want = epochs(port_loader(volumes, 0, True, drop_last=True))
    got = epochs(port_loader(volumes, workers, True, drop_last=True))
    assert len(want) == 2
    assert_batches_equal(want, got)


def test_pool_matches_jax_pool(volumes):
    """The port's and the JAX package's 2-worker streams on the same files
    and chain (the JAX loader's datasets and transforms are numpy)."""
    from fpl_plus_tpu.io.dataset import NiftyDataset as JaxDataset
    from fpl_plus_tpu.io.loader import DataLoader as JaxLoader
    from fpl_plus_tpu.transforms.trans_dict import build_transforms
    jax_ds = JaxDataset(str(volumes), str(volumes / 'm.csv'),
                        with_label=True,
                        transform=build_transforms(CHAIN, PARAMS)[1],
                        cache_bytes=1 << 30)
    jax_loader = JaxLoader(jax_ds, batch_size=2, shuffle=True, num_workers=2,
                           seed=13)
    stream = jax_loader.stream()
    want = [next(stream) for _ in range(5)]
    # the JAX loader's shutdown waits 5 s for a worker whose results are
    # unread: read its results in flight first
    try:
        while True:
            jax_loader._result_q.get(timeout=2)
    except queue.Empty:
        jax_loader.shutdown()
    got = streamed(port_loader(volumes, 2, True))
    for a, b in zip(want, got):
        for key in ('image', 'label', 'label_prob'):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a['names'] == b['names']


@pytest.mark.parametrize('how', ['raise', 'exit'])
def test_worker_failure_raises_with_the_item(how):
    """Item 4 fails in its worker. An exception raises here, naming the
    item, once items 0-3 have arrived in order; a worker that ends raises
    when the loader finds it gone (the items it held are lost, so earlier
    ones may not arrive). Either way the pool stops."""
    loader = DataLoader(FailingAt(4, how), batch_size=2, num_workers=2)
    got = []
    match = 'item 4 ' if how == 'raise' else r'exit code.*\b3\b'
    with pytest.raises(RuntimeError, match=match):
        for batch in loader:
            got.extend(batch['item'])
    assert got == list(range(len(got)))
    if how == 'raise':
        assert got == [0, 1, 2, 3]
    assert loader._pool is None


def test_workers_import_no_torch_and_shutdown_leaves_no_child():
    loader = DataLoader(InterpreterProbe(8), batch_size=8, num_workers=2)
    batch = next(iter(loader))
    assert set(batch['pid']) <= {p.pid for p in loader._pool}
    assert os.getpid() not in set(batch['pid'])
    assert list(batch['torch']) == [0] * 8
    assert list(batch['jax']) == [0] * 8
    # each item's draws come from its own seed, not the worker's history
    ref = DataLoader(InterpreterProbe(8), batch_size=8)
    np.testing.assert_array_equal(batch['draw'], next(iter(ref))['draw'])
    pids = [p.pid for p in loader._pool]
    loader.shutdown()
    assert not any(os.path.exists('/proc/{0}'.format(p)) for p in pids)
    loader.shutdown()                   # idempotent


def shared_segments():
    """The shared-memory segments of ``multiprocessing.shared_memory``."""
    return {n for n in os.listdir('/dev/shm') if n.startswith('psm_')}


def test_prefetched_pools_stop_without_leaks():
    """Two pooled streams read by a prefetch thread, as the train loop
    reads them: closing the prefetch waits for its thread, and the pools'
    shutdown then removes every shared-memory segment in flight."""
    before = shared_segments()
    loaders = [DataLoader(Arrays(6), batch_size=2, shuffle=True, seed=s,
                          num_workers=2) for s in (1, 2)]

    def pairs():
        a, b = (repeat_loader(ld) for ld in loaders)
        while True:
            yield next(a), next(b)

    try:
        batches = prefetch_iter(pairs(), depth=2)
        for _ in range(3):
            a, b = next(batches)
            assert a['image'].shape == (2, 4, 64, 64)
            np.testing.assert_array_equal(a['image'][:, 0, 0, 0], a['item'])
        batches.close()
        assert not [t for t in threading.enumerate()
                    if '_producer' in t.name]
    finally:
        for loader in loaders:
            loader.shutdown()
    assert shared_segments() == before


def agent_config(volumes, workers):
    return {
        'dataset': dict(
            {'task_type': 'seg', 'root_dir': str(volumes),
             'train_csv': str(volumes / 'm.csv'),
             'valid_csv': str(volumes / 'm.csv'),
             'train_csv_unlab': str(volumes / 'm.csv'),
             'train_csv_noise': str(volumes / 'm.csv'),
             'train_batch_size': 2, 'train_batch_size_unlab': 2,
             'train_batch_size_noise': 2, 'num_workder': workers,
             'cache_gb': 0.5, 'train_transform': CHAIN,
             'train_transform_unlab': ['NormalizeWithMeanStd', 'Pad',
                                       'RandomCrop'],
             'valid_transform': ['NormalizeWithMeanStd', 'Pad',
                                 'LabelToProbability']},
            **{k: v for k, v in PARAMS.items() if k != 'task'}),
        'network': {'net_type': 'UNet2D5', 'num_domains': 1, 'class_num': 2},
        'training': {'deterministic': True, 'random_seed': 21,
                     'iter_max': 10},
        'testing': {},
        'semi_supervised_learning': {'ssl_method': 'MeanTeacher'},
        'noisy_label_learning': {'nll_method': 'DAST'},
    }


def test_agent_pool_path_matches_sync(volumes, monkeypatch, caplog):
    """The segmentation agent's train loader with ``num_workder = 2`` on a
    patched 4-core host streams what the synchronous agent streams; the
    train cache budget is split over the workers; a 1-core host clamps the
    request to 0 and logs it."""
    def batches(workers, cores):
        monkeypatch.setattr(os, 'cpu_count', lambda: cores)
        agent = SegmentationAgent(agent_config(volumes, workers), 'train',
                                  'cpu')
        agent.create_dataset()
        loader = agent.train_loaders[0]
        stream = repeat_loader(loader)
        try:
            return loader, [next(stream) for _ in range(4)]
        finally:
            agent.shutdown()

    with caplog.at_level(logging.INFO):
        sync_loader, sync = batches(2, 1)
    assert sync_loader.num_workers == 0
    assert 'num_workder 2 clamped to 0' in caplog.text
    pooled_loader, pooled = batches(2, 4)
    assert pooled_loader.num_workers == 2
    assert pooled_loader._pool is None       # shut down with the agent
    assert pooled_loader.dataset._samples.max_bytes == \
        sync_loader.dataset._samples.max_bytes // 2
    assert_batches_equal(sync, pooled)


def test_paradigm_loaders_get_workers_and_stop_with_the_agent(
        volumes, monkeypatch):
    """The SSL unlabelled loader takes the clamped count, DAST's noisy
    loader the unclamped ``num_workder`` (as in the JAX package); the
    agent's shutdown stops both pools."""
    monkeypatch.setattr(os, 'cpu_count', lambda: 2)
    ssl = SSLMeanTeacher(agent_config(volumes, 3), 'train', 'cpu')
    ssl.create_dataset()
    dast = NLLDAST(agent_config(volumes, 3), 'train', 'cpu')
    dast.create_dataset()
    assert ssl.train_loader_unlab.num_workers == 1
    assert dast.train_loaders[0].num_workers == 1
    assert dast.train_loader_noise.num_workers == 3
    for agent, loader in ((ssl, ssl.train_loader_unlab),
                          (dast, dast.train_loader_noise)):
        assert loader in agent.loaders()
        next(loader.stream())
        pids = [p.pid for p in loader._pool]
        agent.shutdown()
        assert loader._pool is None
        assert not any(os.path.exists('/proc/{0}'.format(p)) for p in pids)
