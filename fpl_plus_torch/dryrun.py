"""Driver entry points of the port (the JAX package's
``__graft_entry__.py``).

``entry(device=None)`` returns the eval forward of the flagship network
(UNet2D5_dsbn at the reference ``vs_t1s_g.cfg`` widths, transposed-conv
decoder) on the device, with its example arguments.

``dryrun_multichip(n_devices, device=None)`` runs the product's whole
four-stage FPL+ pipeline, every stage through ``fpl_plus_torch.cli`` with
``mesh_devices = n`` (the CLI starts the ranks: NCCL, one card each, or
gloo on the CPU under ``device='cpu'``), on a seeded tiny workspace:

  stage 1  pseudo-label generator: dual-domain DSBN training over the
           ranks, then the auto test stage (the target set's labels) and
           the evaluation
  stage 2  pseudo-labels of the fake-source translations, then the FPL
           MC-dropout uncertainty pass (``fpl = True``, the sorted ``.npy``)
  stage 3  the filtering weights: pixel-weight maps and the image-weight
           CSV (``fpl_plus_torch.fpl.weights``, on the host)
  stage 4  the weighted segmentor resumes the generator's checkpoint on
           that CSV (``train_fpl_uda``), then the auto test stage and the
           evaluation on a held-out target volume

and asserts each stage's artifacts, as the JAX dry run does
(``__graft_entry__.py:191-283`` there). Unlike JAX, which moves a
multi-device dry run to a virtual CPU mesh, it runs where it is asked:
``n_devices`` more than the cards present raises.

    python -m fpl_plus_torch.dryrun [N] [--device cpu]

runs ``dryrun_multichip(N)`` (N: the cards present, 2 on the CPU), then
``entry()``'s forward, and prints the output's shape. The script that
starts ranks re-imports this module in each of them, so it keeps its work
under ``if __name__ == '__main__'``.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

# the flagship (__graft_entry__.py:36-41 there)
NET_CFG = {'net_type': 'UNet2D5_dsbn', 'num_domains': 2, 'class_num': 2,
           'in_chns': 1, 'feature_chns': [32, 64, 128, 256, 512],
           'conv_dims': [2, 2, 3, 3, 3],
           'dropout': [0.0, 0.0, 0.3, 0.4, 0.5], 'bilinear': False}
ENTRY_SHAPE = (1, 1, 28, 128, 128)
ENTRY_DOMAIN = 1
# the dry run's net, volumes and sliding window (__graft_entry__.py:52-188)
DRYRUN_NET = dict(NET_CFG, feature_chns=[4, 8, 8, 8, 8],
                  dropout=[0.0, 0.0, 0.1, 0.1, 0.1])
DRYRUN_SHAPE = (12, 24, 24)
DRYRUN_WINDOW = [8, 16, 16]
DRYRUN_STRIDE = [6, 12, 12]
CASES = 2
WEIGHTED_HEADER = 'image,label,pixel_weight,image_weight'


def entry(device=None):
    """``(fn, (x, domain))``: ``fn(x, domain)`` is the flagship's eval
    forward on ``device`` (default ``cuda:0``; raises without a card unless
    ``'cpu'``), weights from ``torch.manual_seed(0)``; ``x`` is a zero
    ``[1, 1, 28, 128, 128]`` f32 window on the device and ``domain`` 1.
    The output is ``[1, 2, 28, 128, 128]`` logits; ``fn.module`` is the
    network."""
    from fpl_plus_torch.device import resolve_device
    from fpl_plus_torch.models.registry import create_network
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        module = create_network(NET_CFG)
    module = module.to(dev).eval()

    @torch.inference_mode()
    def fn(x, domain):
        return module(x, domain)

    fn.module = module
    x = torch.zeros(ENTRY_SHAPE, dtype=torch.float32, device=dev)
    return fn, (x, ENTRY_DOMAIN)


_DRYRUN_CFG = """
[dataset]
task_type = seg
root_dir = {root}
modal_num = 1
1_train_csv = {root}/d0_train.csv
2_train_csv = {root}/{csv2}
1_valid_csv = {root}/d0_valid.csv
2_valid_csv = {root}/d1_valid.csv
test_csv = {root}/{test_csv}
train_batch_size = {batch}
num_workder = 0
train_transform = [NormalizeWithMeanStd, Pad, RandomCrop, LabelToProbability]
valid_transform = [NormalizeWithMeanStd, Pad, LabelToProbability]
test_transform = [NormalizeWithMeanStd, Pad]
NormalizeWithMeanStd_channels = [0]
Pad_output_size = {window}
RandomCrop_output_size = {window}
RandomCrop_foreground_focus = False
RandomCrop_foreground_ratio = 0.5
RandomCrop_mask_label = [1]

[network]
net_type = {net_type}
num_domains = {num_domains}
class_num = {class_num}
in_chns = {in_chns}
feature_chns = {feature_chns}
conv_dims = {conv_dims}
dropout = {dropout}
bilinear = {bilinear}

[training]
mesh_devices = {mesh}
dual = True
train_fpl_uda = {fpl_uda}
val_t2 = True
loss_type = DiceLoss
optimizer = Adam
learning_rate = 1e-3
momentum = 0.9
weight_decay = 0.0
lr_scheduler = MultiStepLR
lr_gamma = 0.5
lr_milestones = [40]
iter_start = {iter_start}
iter_max = {iter_max}
iter_valid = 2
iter_save = 2
ckpt_save_dir = {root}/model/dryrun
{extra_training}

[testing]
mesh_devices = {mesh}
ckpt_mode = 0
domian_label = {domian}
fpl = {fpl}
output_dir = {root}/result
sliding_window_enable = True
sliding_window_size = {window}
sliding_window_stride = {stride}
tta_mode = 1
{extra_testing}

[evaluation]
metric_1 = dice
metric_2 = assd
label_list = [1]
organ_name = tumor
ground_truth_folder_root = {root}
test_evaluation_image_pair = {root}/pairs.csv
valid_evaluation_image_pair = {root}/pairs.csv
"""


def write_workspace(root: str, shape=DRYRUN_SHAPE, cases: int = CASES):
    """The dry run's seeded workspace (``RandomState(5)``): per case, a
    noisy volume of ``shape`` with a bright cube over the middle third of
    each axis and its label, for ``d0`` (source, +3.0), ``d1`` (target,
    +2.5) and ``d1cyc`` (the target's fake-source translations, +3.0, the
    same basenames, which the pixel weights pair by name); the manifests,
    ``final_test.csv`` (the target's case 1) and ``pairs.csv``."""
    from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_nifti
    rs = np.random.RandomState(5)
    geom = ImageGeometry(origin=(0., 0., 0.), spacing=(1.0, 1.0, 1.5),
                         direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
    cube = tuple(slice(s // 3, 2 * s // 3) for s in shape)

    def write_case(sub, case, bright):
        for kind in ('img', 'lab'):
            os.makedirs(os.path.join(root, sub, kind), exist_ok=True)
        vol = rs.normal(0, 1, size=shape).astype(np.float32)
        lab = np.zeros(shape, np.int16)
        lab[cube] = 1
        vol[cube] += bright
        name = 'case{0}.nii.gz'.format(case)
        write_nifti(NiftiImage(vol, geom),
                    os.path.join(root, sub, 'img', name))
        write_nifti(NiftiImage(lab, geom),
                    os.path.join(root, sub, 'lab', name))

    for case in range(cases):
        write_case('d0', case, 3.0)
        write_case('d1', case, 2.5)
        write_case('d1cyc', case, 3.0)

    def manifest(path, sub, rows, with_label=True):
        with open(os.path.join(root, path), 'w') as f:
            f.write('image,label\n' if with_label else 'image\n')
            for c in rows:
                row = '{0}/img/case{1}.nii.gz'.format(sub, c)
                if with_label:
                    row += ',{0}/lab/case{1}.nii.gz'.format(sub, c)
                f.write(row + '\n')

    for sub in ('d0', 'd1'):
        manifest('{0}_train.csv'.format(sub), sub, range(cases))
        manifest('{0}_valid.csv'.format(sub), sub, [0])
    manifest('d1_train_img.csv', 'd1', range(cases), with_label=False)
    manifest('d1cyc_train_img.csv', 'd1cyc', range(cases), with_label=False)
    with open(os.path.join(root, 'final_test.csv'), 'w') as f:
        f.write('image\nd1/img/case1.nii.gz\n')
    with open(os.path.join(root, 'pairs.csv'), 'w') as f:
        f.write('gt,seg\nd1/lab/case1.nii.gz,case1.nii.gz\n')


def write_cfg(root: str, name: str, n_devices: int, net_cfg=DRYRUN_NET,
              window=DRYRUN_WINDOW, stride=DRYRUN_STRIDE, **kw) -> str:
    """The dry run's config ``root/name`` for a mesh of ``n_devices``; the
    keyword arguments fill the template's per-stage fields."""
    kw.setdefault('csv2', 'd1_train.csv')
    kw.setdefault('test_csv', 'd1_train_img.csv')
    kw.setdefault('fpl_uda', 'False')
    kw.setdefault('iter_start', 0)
    kw.setdefault('iter_max', 2)
    kw.setdefault('domian', 1)
    kw.setdefault('fpl', 'False')
    kw.setdefault('extra_training', '')
    kw.setdefault('extra_testing', '')
    net = {k: net_cfg[k] for k in ('net_type', 'num_domains', 'class_num',
                                   'in_chns', 'feature_chns', 'conv_dims',
                                   'dropout', 'bilinear')}
    path = os.path.join(root, name)
    with open(path, 'w') as f:
        f.write(_DRYRUN_CFG.format(root=root, mesh=n_devices,
                                   batch=max(n_devices, 2),
                                   window=list(window), stride=list(stride),
                                   **net, **kw))
    return path


def _niftis(path: str):
    return sorted(n for n in os.listdir(path) if n.endswith('.nii.gz'))


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _pipeline(root: str, n_devices: int, device, net_cfg=DRYRUN_NET,
              shape=DRYRUN_SHAPE, window=DRYRUN_WINDOW, stride=DRYRUN_STRIDE,
              extra_training: str = '') -> dict:
    """The four stages on a workspace written under ``root``, through the
    CLI on ``device`` (``'cpu'`` or a card) with ``mesh_devices =
    n_devices``, asserting each stage's artifacts. ``net_cfg``, ``shape``,
    ``window`` / ``stride`` (the crop and Pad size is the window) and the
    ``[training]`` lines ``extra_training`` size the run. Returns each
    stage's wall seconds (``walls``), the directories of stage 1's and
    stage 4's labels and evaluation (``pseudo_target``, ``final_dir``) and
    the FPL list (``uncertainty``)."""
    from fpl_plus_torch.cli import main
    from fpl_plus_torch.fpl.weights import (compute_pixel_weights,
                                            write_image_weight_csv)
    device = str(device)
    write_workspace(root, shape)
    sizes = dict(net_cfg=net_cfg, window=window, stride=stride,
                 extra_training=extra_training)
    walls = {}

    def run(stage, argv):
        t0 = time.perf_counter()
        rc = main(argv, device=device)
        walls[stage] = walls.get(stage, 0.0) + time.perf_counter() - t0
        _check(rc == 0, '{0} failed (rc={1})'.format(stage, rc))

    # -- stage 1: generator train + auto test + eval over the ranks -------
    run('1', ['train', write_cfg(root, 'gen.cfg', n_devices, **sizes)])
    ckpt_dir = os.path.join(root, 'model', 'dryrun')
    _check(os.path.exists(os.path.join(ckpt_dir, 'dryrun_best.txt')),
           'stage 1 wrote no best pointer')
    names = ['case{0}.nii.gz'.format(c) for c in range(CASES)]
    pseudo_t = os.path.join(root, 'result', 'dryrun_d1_train_img')
    _check(_niftis(pseudo_t) == names, 'missing target pseudo-labels')

    # -- stage 2a: pseudo-labels of the fake-source translations ----------
    run('2', ['test', write_cfg(root, 'gen_fake.cfg', n_devices,
                                test_csv='d1cyc_train_img.csv', domian=0,
                                **sizes)])
    pseudo_f = os.path.join(root, 'result', 'dryrun_d1cyc_train_img')
    _check(_niftis(pseudo_f) == names, 'missing fake pseudo-labels')

    # -- stage 2b: the FPL MC-dropout uncertainty pass (fpl = True) -------
    unc_npy = os.path.join(root, 'unc_sorted.npy')
    run('2', ['test', write_cfg(
        root, 'gen_w.cfg', n_devices, fpl='True', extra_testing=(
            'test_time_dropout = True\nfpl_uncertainty_sorted = {0}\n'
            .format(unc_npy)), **sizes)])
    _check(len(np.load(unc_npy, allow_pickle=True)) == CASES,
           'uncertainty npy incomplete')

    # -- stage 3: filtering weights from the produced artifacts -----------
    t0 = time.perf_counter()
    pw_dir = os.path.join(root, 'weights', 'pixel')
    _check(len(compute_pixel_weights(pseudo_t, pseudo_f, pw_dir)) == CASES,
           'missing pixel-weight maps')
    weighted_csv = os.path.join(root, 'd1_train_weighted.csv')
    n_rows = write_image_weight_csv(
        unc_npy, weighted_csv, image_dir='',
        pseudo_label_dir='result/dryrun_d1_train_img',
        pixel_weight_dir='weights/pixel')
    _check(n_rows == CASES, 'weighted CSV incomplete')
    with open(weighted_csv) as f:
        header = f.readline().strip()
    _check(header == WEIGHTED_HEADER, header)
    walls['3'] = time.perf_counter() - t0

    # -- stage 4: the weighted segmentor resumes the generator ------------
    run('4', ['train', write_cfg(root, 'seg_final.cfg', n_devices,
                                 csv2='d1_train_weighted.csv',
                                 fpl_uda='True', iter_start=2, iter_max=4,
                                 test_csv='final_test.csv', **sizes)])
    _check(os.path.exists(os.path.join(ckpt_dir, 'dryrun_4.pt')),
           'the resume did not continue from the generator checkpoint')
    out_dir = os.path.join(root, 'result', 'dryrun_final_test')
    _check(os.path.exists(os.path.join(out_dir, 'case1.nii.gz')),
           'missing final-segmentor prediction')
    _check(os.path.exists(os.path.join(out_dir, 'test_tumor_dice_all.csv')),
           'missing eval CSV')
    return {'walls': walls, 'pseudo_target': pseudo_t,
            'uncertainty': unc_npy, 'final_dir': out_dir}


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The four-stage FPL+ pipeline over ``n_devices`` ranks (module
    docstring) in a temporary directory; raises when a stage fails or when
    fewer than ``n_devices`` cards (on the CPU: cores) are present."""
    from fpl_plus_torch.device import resolve_device
    from fpl_plus_torch.parallel.mesh import local_device_count
    dev = resolve_device(device)
    have = local_device_count(dev.type)
    if n_devices > have:
        raise RuntimeError('need {0} {1} devices, have {2}'.format(
            n_devices, dev.type, have))
    with tempfile.TemporaryDirectory(prefix='fplx_dryrun_') as root:
        _pipeline(root, n_devices, dev)
    print('dryrun_multichip OK: {0} rank(s) on {1} through the FULL 4-stage '
          'FPL+ pipeline (data-parallel dual-domain train + window-sharded '
          'pseudo-labelling + FPL uncertainty pass + weight emission + '
          'weighted resume + eval)'.format(n_devices, dev.type))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog='python -m fpl_plus_torch.dryrun')
    parser.add_argument('n_devices', nargs='?', type=int, default=None,
                        help='ranks (default: the cards present, 2 on the '
                             'CPU)')
    parser.add_argument('--device', default=None,
                        help='cuda[:i] (default cuda:0) or cpu')
    args = parser.parse_args(argv)
    n = args.n_devices
    if n is None:
        n = 2 if args.device == 'cpu' else torch.cuda.device_count()
    dryrun_multichip(n, args.device)
    fn, fn_args = entry(args.device)
    print('entry forward:', tuple(fn(*fn_args).shape))
    return 0


if __name__ == '__main__':
    sys.exit(main())
