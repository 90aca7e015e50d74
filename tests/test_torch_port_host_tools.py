"""PyTorch port, the host tools and data classes of slice 8 against the JAX
package's, on the CPU with no JAX compile:

* checkpoint surgery: averaging JAX checkpoints and converting the mean
  equals converting them and averaging with ``python -m
  fpl_plus_torch.utils.model_operate average`` (both average the
  parameters in float64 and keep the first checkpoint's statistics);
  ``engine/ckpt.average_checkpoints``' float64 mean; a ``rename`` round
  trip;
* ``python -m fpl_plus_torch.utils.preprocess`` against the JAX
  package's ``preprocess_with_transform``, voxel for voxel and geometry;
* ``NiftyDatasetNpy`` (pseudo-label bundles and plain labels),
  ``NiftyDatasetDual`` and ``H5Dataset`` samples equal to the JAX
  package's;
* ``rotate_nifty_volume_to_lps``, the ``utils/image_process.py`` helpers
  and ``create_pair_csv`` equal to the JAX package's.
"""
import numpy as np
import pytest
import torch

import fpl_plus_tpu.utils.image_process as jax_ip
from fpl_plus_torch.cli import shell
from fpl_plus_torch.engine.ckpt import average_checkpoints, load_checkpoint
from fpl_plus_torch.io import dataset as port_ds
from fpl_plus_torch.io.image_io import rotate_nifty_volume_to_lps
from fpl_plus_torch.io.nifti import (ImageGeometry, NiftiImage, read_image,
                                     write_nifti)
from fpl_plus_torch.utils import image_process as port_ip
from fpl_plus_torch.utils import model_operate, preprocess


def fill(shapes, seed):
    """A narrow UNet2D5_dsbn's JAX variables from their shapes and a numpy
    seed (``jax.eval_shape`` of the init: no compile)."""
    import jax
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: rs.uniform(0.5, 1.5, s.shape).astype(np.float32), shapes)


def test_average_then_convert_equals_convert_then_average(tmp_path):
    import jax
    import jax.numpy as jnp
    from fpl_plus_tpu.engine.ckpt import save_checkpoint as jax_save
    from fpl_plus_tpu.models.registry import create_network as jax_create
    from fpl_plus_tpu.utils.model_operate import get_average_model
    from tests.test_torch_port_convert import NET5, write_cfg

    module = jax_create(NET5)
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        jnp.zeros((1, 8, 32, 32, 1)), 0, True))
    jax_ckpts, port_ckpts = [], []
    cfg = write_cfg(tmp_path / 'net.cfg', NET5)
    for i, seed in enumerate((1, 2, 3)):
        v = fill(shapes, seed)
        jax_ckpts.append(jax_save(str(tmp_path / 'jax'), 'm', i + 1,
                                  {'params': v['params'],
                                   'batch_stats': v['batch_stats'],
                                   'opt_state': {}}, 0.5))
        port_ckpts.append(str(tmp_path / 'port' / 'm_{0}.pt'.format(i + 1)))
        assert shell(['convert', jax_ckpts[-1], cfg, port_ckpts[-1]]) == 0
    get_average_model(jax_ckpts, str(tmp_path / 'jax' / 'avg.ckpt'))
    assert shell(['convert', str(tmp_path / 'jax' / 'avg.ckpt'), cfg,
                  str(tmp_path / 'a' / 'avg_0.pt')]) == 0
    assert model_operate.main(['average'] + port_ckpts + [
        '--output', str(tmp_path / 'avg.pt')]) == 0
    want = load_checkpoint(str(tmp_path / 'a' / 'avg_0.pt'))
    got = load_checkpoint(str(tmp_path / 'avg.pt'))
    assert list(got['model_state_dict']) == list(want['model_state_dict'])
    for key, value in want['model_state_dict'].items():
        torch.testing.assert_close(got['model_state_dict'][key], value,
                                   rtol=0, atol=0, msg=key)
    first = load_checkpoint(port_ckpts[0])['model_state_dict']
    torch.testing.assert_close(
        got['model_state_dict']['block0.conv.bn2d1.bns.1.running_var'],
        first['block0.conv.bn2d1.bns.1.running_var'], rtol=0, atol=0)


def test_average_checkpoints_is_the_float64_mean(tmp_path):
    rs = np.random.RandomState(4)
    sds = [{'w': torch.from_numpy(rs.normal(size=(3, 5)).astype(np.float32)),
            'h': torch.from_numpy(rs.normal(size=4)).to(torch.bfloat16),
            'n': torch.tensor(k + 1, dtype=torch.int64)} for k in range(3)]
    paths = []
    for k, sd in enumerate(sds):
        paths.append(str(tmp_path / 'c_{0}.pt'.format(k)))
        torch.save({'iteration': k, 'model_state_dict': sd}, paths[-1])
    mean = average_checkpoints(paths)
    for key, sd0 in sds[0].items():
        want = np.mean([sd[key].double().numpy() for sd in sds], axis=0)
        assert mean[key].dtype == sd0.dtype
        np.testing.assert_array_equal(
            mean[key].double().numpy(),
            torch.from_numpy(np.asarray(want)).to(sd0.dtype).double().numpy())
    assert int(mean['n']) == 2
    with pytest.raises(ValueError, match='no checkpoints'):
        average_checkpoints([])


def test_rename_round_trip(tmp_path):
    sd = {'a.weight': torch.ones(2), 'b.bias': torch.zeros(3)}
    src = str(tmp_path / 'in.pt')
    torch.save({'iteration': 4, 'model_state_dict': sd,
                'optimizer_state_dict': {'x': 1}}, src)
    mid, back = str(tmp_path / 'mid.pt'), str(tmp_path / 'back.pt')
    assert model_operate.main(['rename', src, mid, '--from', 'a.weight',
                               '--to', 'c.weight']) == 0
    renamed = load_checkpoint(mid)
    assert list(renamed['model_state_dict']) == ['c.weight', 'b.bias']
    assert renamed['optimizer_state_dict'] == {'x': 1}
    model_operate.rename_model_variable(mid, back, ['c.weight'],
                                        ['a.weight'])
    restored = load_checkpoint(back)['model_state_dict']
    assert list(restored) == list(sd)
    for key in sd:
        torch.testing.assert_close(restored[key], sd[key], rtol=0, atol=0)
    with pytest.raises(KeyError, match='no entries'):
        model_operate.rename_model_variable(src, back, ['zz'], ['yy'])


GEOM = ImageGeometry(origin=(-3., 7., 1.), spacing=(0.5, 0.75, 2.0),
                     direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))


@pytest.fixture
def volume(tmp_path):
    rs = np.random.RandomState(11)
    img = rs.normal(80., 20., size=(10, 30, 36)).astype(np.float32)
    lab = np.zeros((10, 30, 36), np.int16)
    lab[3:7, 9:21, 10:25] = 1
    write_nifti(NiftiImage(img, GEOM), str(tmp_path / 'img.nii.gz'))
    write_nifti(NiftiImage(lab, GEOM), str(tmp_path / 'lab.nii.gz'))
    return tmp_path, img, lab


def test_preprocess_matches_jax(volume):
    from fpl_plus_tpu.utils.preprocess import (
        get_transform_list as jax_transforms,
        preprocess_with_transform as jax_preprocess)
    d, _, _ = volume
    cfg = d / 'chain.cfg'
    cfg.write_text('[dataset]\ntransform = [NormalizeWithMeanStd, '
                   'CenterCrop, Pad]\nNormalizeWithMeanStd_channels = [0]\n'
                   'CenterCrop_output_size = [8, 24, 30]\n'
                   'Pad_output_size = [12, 24, 40]\n')
    img, lab = str(d / 'img.nii.gz'), str(d / 'lab.nii.gz')
    jax_preprocess(jax_transforms(str(cfg)), img, str(d / 'jax_img.nii.gz'),
                   lab, str(d / 'jax_lab.nii.gz'))
    assert preprocess.main([str(cfg), img, str(d / 'img_out.nii.gz'),
                            '--label-in', lab, '--label-out',
                            str(d / 'lab_out.nii.gz')]) == 0
    for ours, theirs in (('img_out', 'jax_img'), ('lab_out', 'jax_lab')):
        got = read_image(str(d / (ours + '.nii.gz')))
        want = read_image(str(d / (theirs + '.nii.gz')))
        assert got.data.dtype == want.data.dtype
        np.testing.assert_array_equal(got.data, want.data)
        assert got.geometry == want.geometry
    assert read_image(str(d / 'img_out.nii.gz')).data.shape == (12, 24, 40)


def assert_same_sample(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, (np.ndarray, np.generic)):
            assert np.asarray(g).dtype == np.asarray(w).dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


@pytest.mark.parametrize('case', ['npy-fpl', 'npy-label', 'dual'])
def test_nifty_dataset_variants_match_jax(volume, case):
    from fpl_plus_tpu.io import dataset as jax_ds
    d, img, lab = volume
    if case == 'npy-fpl':
        np.save(str(d / 'bundle.npy'), {
            'predict': lab[None].astype(np.uint8),
            'pixel_wise_weight': np.random.RandomState(2).uniform(
                0, 2, lab.shape).astype(np.float64),
            'sample_wise_weight': 0.625}, allow_pickle=True)
        rows = 'image,label\nimg.nii.gz,bundle.npy\n'
    elif case == 'npy-label':
        rows = 'image,label\nimg.nii.gz,lab.nii.gz\n'
    else:
        write_nifti(NiftiImage(img * 0.5, GEOM), str(d / 'nonl.nii.gz'))
        rows = ('image,label,pixel_weight_nonl\n'
                'img.nii.gz,lab.nii.gz,nonl.nii.gz\n')
    (d / 'm.csv').write_text(rows)
    args = (str(d), str(d / 'm.csv'))
    if case == 'dual':
        want = jax_ds.NiftyDatasetDual(*args, with_label=True)[0]
        got = port_ds.NiftyDatasetDual(*args, with_label=True)[0]
        np.testing.assert_array_equal(got['image1'], got['image'] * 0.5)
    else:
        fpl = case == 'npy-fpl'
        want = jax_ds.NiftyDatasetNpy(*args, train_fpl_uda=fpl,
                                      with_label=True)[0]
        got = port_ds.NiftyDatasetNpy(*args, train_fpl_uda=fpl,
                                      with_label=True)[0]
        assert ('pixel_weight' in got) == fpl
    assert_same_sample(got, want)


def test_h5_dataset_matches_jax(tmp_path):
    import h5py
    from fpl_plus_tpu.io.dataset import H5Dataset as JaxH5
    rs = np.random.RandomState(6)
    for i in range(2):
        with h5py.File(str(tmp_path / 's{0}.h5'.format(i)), 'w') as f:
            f['image'] = rs.normal(size=(1, 12, 16))
            f['label'] = rs.randint(0, 3, size=(1, 12, 16)).astype(np.uint8)
    (tmp_path / 'list.txt').write_text('s0.h5\n\ns1.h5\n')
    want = JaxH5(str(tmp_path), str(tmp_path / 'list.txt'))
    got = port_ds.H5Dataset(str(tmp_path), str(tmp_path / 'list.txt'))
    assert len(got) == len(want) == 2
    for i in range(2):
        assert_same_sample(got[i], want[i])


def test_rotate_to_lps_matches_jax():
    from fpl_plus_tpu.io.image_io import rotate_nifty_volume_to_lps as jax_rot
    data = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    for direction in ((-1, 0, 0, 0, 1, 0, 0, 0, -1),
                      (1, 0, 0, 0, -1, 0, 0, 0, 1), (1, 0, 0, 0, 1, 0, 0, 0, 1),
                      0):
        image = {'data_array': data, 'direction': direction, 'origin': (0,)}
        got, want = rotate_nifty_volume_to_lps(image), jax_rot(image)
        np.testing.assert_array_equal(got['data_array'], want['data_array'])
        assert got['direction'] == want['direction']
        assert got['origin'] == want['origin']


def test_image_helpers_match_jax():
    rs = np.random.RandomState(8)
    vol = np.zeros((9, 20, 24), np.float32)
    vol[2:6, 5:12, 8:20] = rs.uniform(1, 2, (4, 7, 12))
    for margin in (None, [1, 3, 30]):
        assert port_ip.get_nd_bounding_box(vol, margin) == \
            jax_ip.get_nd_bounding_box(vol, margin)
    lo, hi = [1, 4, 6], [7, 15, 22]
    np.testing.assert_array_equal(
        port_ip.crop_nd_volume_with_bounding_box(vol, lo, hi),
        jax_ip.crop_nd_volume_with_bounding_box(vol, lo, hi))
    sub = rs.normal(size=(6, 11, 16)).astype(np.float32)
    for addition in (True, False):
        np.testing.assert_array_equal(
            port_ip.set_nd_volume_roi_with_bounding_box_range(
                vol.copy(), lo, hi, sub, addition),
            jax_ip.set_nd_volume_roi_with_bounding_box_range(
                vol.copy(), lo, hi, sub, addition))
    for shape, mode in (([5, 25, 24], 'constant'), ([12, 9, 31], 'reflect')):
        np.testing.assert_array_equal(
            port_ip.crop_and_pad_nd_array_to_desired_shape(vol, shape, mode),
            jax_ip.crop_and_pad_nd_array_to_desired_shape(vol, shape, mode))
    mask = (vol > 0).astype(np.uint8)
    np.testing.assert_array_equal(port_ip.get_euclidean_distance(mask),
                                  jax_ip.get_euclidean_distance(mask))
    for order in (0, 1, 3):
        np.testing.assert_array_equal(
            port_ip.resample_to_spacing(vol, (2.0, 0.5, 0.5), (1.5, 0.8, 1.0),
                                        order),
            jax_ip.resample_to_spacing(vol, (2.0, 0.5, 0.5), (1.5, 0.8, 1.0),
                                       order))


def test_create_pair_csv_matches_jax(tmp_path):
    from fpl_plus_tpu.fpl.manifests import create_pair_csv as jax_pairs
    from fpl_plus_torch.fpl.manifests import create_pair_csv
    gt, seg = ['lab/a.nii.gz', 'lab/b,c.nii.gz'], ['a.nii.gz', 'b.nii.gz']
    create_pair_csv(gt, seg, str(tmp_path / 'port' / 'pairs.csv'))
    jax_pairs(gt, seg, str(tmp_path / 'jax' / 'pairs.csv'))
    assert (tmp_path / 'port' / 'pairs.csv').read_text() == \
        (tmp_path / 'jax' / 'pairs.csv').read_text()
    with pytest.raises(ValueError):
        create_pair_csv(gt, seg[:1], str(tmp_path / 'x.csv'))
