"""Chip smoke test of the PyTorch port (fpl_plus_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

It builds the port's Triton kernels (cache under ``build/triton``) and the
evaluation's C++ distance transform (``build/native``) from this checkout,
then runs, each phase failing the script on any error:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. kernel: ``dsbn_prelu`` (Triton) against ``dsbn_prelu_reference`` (plain
   PyTorch) on the card, at every (C, spatial) shape a flagship window
   forward gives it (batch 8 = 4 TTA variants x patch_chunk 2) plus a ragged
   one, domains 0 and 1, f32, bf16 and f16, without and with a convolution's
   bias folded in (at f32 bit for bit the bias ``add_`` and the bias-free
   kernel); CUDA-event times of the kernel, of the kernel with the bias
   folded in and of ``add_`` + the bias-free kernel, beside the byte
   bound, and at the largest shape, at each type, of the plain version and
   of F.batch_norm + F.prelu (a two-call yardstick: no single PyTorch call
   computes this function);
3. forward: one [1,1,28,128,128] eval window of the full-width UNet2D5_dsbn
   (random weights from a seeded torch.Generator, non-trivial running
   statistics, domain 1) on the card (kernel) and on the CPU (plain), TF32 off;
4. serving: the pseudo-label test stage through ``fpl_plus_torch.cli.main``
   on 3 seeded 40x160x272 NIfTI volumes with the phase-3 weights saved as a
   reference-layout ``.pt`` checkpoint, at f32, bf16 and f16; the launch
   counter must equal 18 x the network forwards of each run, and the
   conv-bias fold counter the launches; the bf16 and
   f16 labels' agreement with f32's;
5. main-path kernel shapes: the kernel against its plain version at every
   shape of the FPL pass's forwards (batch 48 = 6 passes x 4 flips x
   patch_chunk 2) and of batched serving's (batch 24 = 3 volumes x 4 flips
   x patch_chunk 2), the three types and both domains, with times and byte
   bounds;
6. fold: 6 MC-dropout passes folded into one batched inference against 6
   sequential passes under the same card generators, full width, TF32 off;
   then the FPL reduction of those logits on the card against the CPU;
7. fpl: the ``fpl = True`` stage through ``fpl_plus_torch.cli.main`` on the
   phase-4 volumes at f32, bf16 and f16: a sorted ``.npy`` of 3 finite
   entries, 3 x 6 network forwards, 18 launches each, each with its conv
   bias folded in; CUDA-event time of the
   pass per volume and peak device memory; the bf16 and f16 lists against
   f32's (order, largest relative gap);
8. batched: ``test_batch_size = 3`` serving through the CLI, timed, labels
   against the phase-4 per-volume labels; then with TF32 off, batched
   against per-volume labels;
9. tools: ``python -m fpl_plus_torch.fpl pixel-weight`` (f32 vs bf16 labels)
   and ``image-weight`` (the f32 ``.npy``) into the weighted train CSV;
10. grad refusal: the kernel's wrapper raises on the card when autograd
    would need its backward, for the tables or a conv bias (and runs under
    ``torch.no_grad()``);
11. train step, card vs CPU: one joint step of the full-width network
    (dropout 0, TF32 off, identical weights and one [28,128,128] crop per
    domain) through ``engine/train.py``: loss, both class dice, every
    parameter's gradient and the updated DSBN running statistics; no conv
    bias folded;
12. timed train step at the flagship setting (batch 4+4 crops of
    [28,128,128], ``train_fpl_uda`` DiceLoss with pixel and image weights,
    Adam, the network's dropout): median CUDA-event ms per step over 12
    steps after 3 warm-up steps, and peak device memory, at f32 (TF32),
    bf16 and f16, the losses against f32's; TFLOP per step counted from the
    module shapes; the share of gradient entries exactly zero after one
    step at each type, and of the logits' gradient the shares exactly
    zero and (at f32) under f16's smallest subnormal and normal numbers
    (the f16 underflow: no loss scaling, as in the JAX package); the
    batch-norm kernels one step launches at each type, named from a
    ``torch.profiler`` trace;
13. train: ``fpl_plus_torch.cli train`` on labelled 40x160x272 volumes
    (generator run, 4 iterations with validation and checkpoints every 2,
    then the auto test stage and the ``[evaluation]`` reports, dice and
    assd), then the weighted segmentor run that resumes it at iteration 4
    on phase 9's CSV (``train_fpl_uda``, bf16, to iteration 6): checkpoints
    and pointers, the resumed optimizer's step count, finite losses, the
    host wait per iteration, and validation and auto-test launches equal to
    18 x the eval-mode forwards;
14. evaluation: the CSVs ``eva_main`` wrote in phase 13 are finite, ``python
    -m fpl_plus_torch.metrics`` alone writes the same ones, seconds per
    volume; the C++ distance transform against its plain version on a crop
    of an edge map, and its time on one whole 40x160x272 edge map;
15. training variants through ``cli train``, 2 iterations each at f32:
    ``dual = False`` (alternating), ``grad_accum_steps = 2`` (2 + 2 crops
    per microbatch), ``dis = True`` and ``dual_consistency = True`` (an
    ``image1`` column, ``consistency_start = 0``): Adam's update count (2
    per iteration for alternating and dual consistency, else 1), finite
    losses (``loss_dis``, ``loss_consis``), the discriminator in the
    checkpoint, launches equal to 18 x the eval-mode forwards counting the
    steps' own, CUDA-event ms per step and peak device memory;
16. card vs CPU: one full-width alternating step and one dual-consistency
    step at gate 1 (SGD, TF32 off, dropout 0, 1 + 1 crops), phase 11's
    tolerances on loss, dice, the second update's gradients and the
    statistics;
17. test paths through the CLI: ``infer_device_label = False`` (host
    inverse; labels against phase 4's) and the FPL host fallback
    (uncertainties against phase 7's), ``ckpt_mode = 3`` over phase 13's
    ``train_2.pt`` and ``train_4.pt`` and over ``[train_4, train_4]``
    (labels equal to one checkpoint's), and a CenterCrop chain; launches
    and ms per volume of each;
18. network zoo: each new network of the registry (UNet2D plain and with
    deep supervision, UNet2D_ScSE, DualBranch, URPC, CCT, AttentionUNet2D,
    NestedUNet2D, COPLENet, UNet3D plain and with deep supervision,
    UNet3D_ScSE, AEs) card vs CPU at small width (TF32 off, one state
    dict, phase 3's tolerance), then one eval forward at the FPL+ widths of
    8 windows ([28,128,128] folded to 8 x 28 slices for the 2D nets,
    [32,128,128] for the 3D ones): CUDA-event ms (median of 5), GMAC per
    window counted from the module shapes, peak device memory; none may
    launch the DSBN+PReLU kernel;
19. zoo training: 3 single-domain steps per new network (the deep-
    supervised UNet2D and UNet3D with DeepSuperviseLoss over DiceLoss;
    DualBranch, CCT and URPC hand the loss their train-mode lists), batch
    4 crops, Adam: ms per step, peak memory, no kernel launch;
20. supervised CLI path: ``cli train`` of a single-domain deep-supervised
    UNet2D at full width (4 iterations, RandomRotate, RandomRescale,
    GammaCorrection, GaussianNoise and NormalizeWithPercentiles in its
    chain), the auto test stage on the phase-4 volumes and ``eva_main``,
    with 0 kernel launches; then the Inferer with a UNet2D_URPC predictor
    (4 heads) card vs CPU under both ``multiscale_counter`` modes;
21. SSL steps (``fpl_plus_torch/agents/ssl.py``): one step of each of the
    6 methods card vs CPU at small widths (SGD, TF32 off, dropout 0, the
    teacher's noise zeroed, CCT's and URPC's train-mode draws taken from
    the same CPU generators): loss components, gradients, BN statistics
    and the EMA teacher by phase 11's tolerances; then 3 steps of each at
    full width (EntropyMinimization, MeanTeacher, UAMT with 8 MC passes
    and CPS on UNet2D5 at NET_CFG with one domain, CCT and URPC on their
    zoo nets; 2 + 2 crops of [28,128,128], Adam): ms per step and peak
    memory, no kernel launch;
22. WSL steps (``agents/wsl.py``): the same for the 6 WSL methods on
    UNet2D5 with 2 scribbled crops (GatedCRF at radius 5, USTM with 8
    passes, DMPLS as a BiNet);
23. the paradigm CLIs at full width on phase 13's workspace:
    ``main_ssl train`` of MeanTeacher (6 iterations, validation and
    checkpoints every 3, the auto test stage on the phase-4 volumes and
    ``eva_main``), its resume (the restored teacher equals the saved one),
    ``main_wsl train`` of GatedCRF on scribbles through
    ``PartialLabelToProbability``, and ``main_ssl test`` of a BiNet (CPS):
    launches equal to 18 x the eval-mode UNet2D5 forwards of each run;
24. NLL steps (``agents/nll.py``): one step of CoTeaching and TriNet and 6
    of DAST card vs CPU at small widths (SGD, TF32 off, dropout 0, noisy
    labels): the small-loss masks identical (a voxel may differ only where
    its CE ties the keep cutoff), DAST's gate sequence identical, loss
    components, gradients and BN statistics by phase 11's tolerances; then
    3 steps of each at full width (UNet2D5 at NET_CFG, one domain, 4 crops
    of [28,128,128], DAST 2 + 2, Adam, the network's dropout): ms per step
    and peak memory, no kernel launch;
25. the NLL CLIs at full width on phase 13's workspace: noisy labels from
    ``python -m fpl_plus_torch.utils.make_noise``; ``cli nll train`` of
    CoTeaching on them (validation, checkpoints, the auto test stage and
    ``eva_main``) and of DAST with ``train_csv_noise``; ``cli nll test``
    of a TriNet checkpoint; ``cli nll_clslsr`` over phase 13's train
    manifest with its generator checkpoint (the ``slsr_conf/`` maps in {0,
    255} at the label shapes, the ``_clslsr.csv`` manifest); a 2-iteration
    ``cli train`` with SLSRLoss on that manifest: launches equal to 18 x
    the UNet2D5 eval forwards of each run (36 per BiNet forward, 54 per
    TriNet forward);
26. classification: ResNet18, VGG16 and MobileNetV2 card vs CPU on one
    state dict (eval forward, one SGD step; TF32 off); 3 train steps of
    each at batch 8 x 3 x 224^2 (ms, peak memory); ``cli train`` + ``cli
    test`` of ResNet18 with ``task_type = cls`` on RGB PNGs and
    ``main_eval_cls`` on its probabilities: no kernel launch;
27. the train loader's worker pool (``io/loader.py``): phase 13's
    flagship stream (batch 4, domain 2) at ``num_workder = 8`` (clamped to
    ``cpu_count - 1``) against the synchronous path, every array of 8
    batches bit-equal, batches/s of both; then phase 13's generator ``cli
    train`` (4 iterations, validation every 2, the auto test stage) with
    the pool: step-call ms, host wait per iteration and validation ms per
    volume beside phase 13's synchronous figures, launches equal to 18 x
    the eval forwards, no torch or CUDA library mapped in a worker and no
    worker alive after the run (phases 13 and 15 run with ``num_workder =
    0``; the other train CLIs take the default pool);
28. host tools: ``python -m fpl_plus_torch.utils.model_operate average`` of
    phase 13's ``train_2.pt`` and ``train_4.pt`` (parameters equal to their
    float64 mean cast back, statistics the first's), a ``ckpt_mode = 2``
    test stage of it through the CLI on the phase-4 volumes (labels in
    {0, 1}, 18 launches per forward), a ``rename`` round trip, and ``python
    -m fpl_plus_torch.utils.preprocess`` on a phase-4 volume against the
    same chain applied in memory;
29. the converter: ``python -m fpl_plus_torch.cli convert`` of the
    committed JAX checkpoint ``tests/data/jax_ckpt/jax_3.ckpt`` (no JAX
    imported), then the port's forward of its window on the card, domains
    0 and 1, against the JAX logits stored beside it, by phase 3's
    tolerance, 18 launches each;
30. scale-out partition math at full width: two spawned ranks on cuda:0,
    a gloo group that the phase builds and hands to the port's ``Mesh``
    (NCCL refuses two ranks on one card): the flagship joint step (4 + 4
    crops split 2 + 2 per rank, the network's dropout from seeded card
    generators, Adam, TF32 off) against one process on the same card from
    the same weights, batch and generators, by phase 11's tolerances on
    loss, class dice, gradients and both banks' running statistics, the
    parameters after Adam equal where the gradient is above its tolerance
    and both ranks' states equal; then the 40x160x272 volume with 4-flip
    TTA sharded over windows (logits by phase 6's tolerance, labels by
    phase 8's agreement), ``run_batch`` of 3 volumes sharded over volumes,
    and the 6 dropout passes sharded over passes (logits, and the FPL pair
    by phase 6's tolerances): correctness runs, host seconds printed, not
    scaling;
31. the NCCL path end to end at world size 1: ``cli train`` with
    ``[training] multihost = True`` and the ``FPLX_*`` triple of one
    process (group, warm-up, the three barriers through NCCL, the primary
    rank's writes, the auto test stage, ``eva_main``, the group closed),
    18 launches per eval forward; then an NCCL group of one in this
    process: the sharded step and the sharded Inferer against the plain
    ones, and both steps timed (CUDA events): the wrapper's cost. The
    collectives' bytes per step and per volume are reckoned and printed;
32. the SSL, WSL and NLL steps over a mesh: each of the 15 methods at full
    width (UNet2D5 at NET_CFG with one domain, CCT and URPC on their zoo
    nets; global batch 2 + 2 crops of [28,128,128], 2 for WSL, CoTeaching
    and TriNet; Adam, the network's dropout and the teacher's noise; one
    step, DAST three) on two spawned gloo ranks on cuda:0 against one
    process on the same card from the same weights, batch and generators,
    TF32 off: phase 11's tolerances on the first step's loss components,
    dice, gradients and statistics, the parameters after Adam, the EMA
    teacher, CoTeaching's and TriNet's masks (a voxel may differ only at a
    tie of the keep cutoff) and DAST's gates; the ranks' states, teachers,
    masks and gates identical (rank 1 skews its host values: USTM's
    rotation and DMPLS's ``beta`` must be rank 0's); host seconds, peak
    memory and the gathered and all-reduced bytes per step; no launch;
33. the paradigm CLIs through NCCL at world size 1 (the ``FPLX_*`` triple
    of one process, ``multihost = True``): ``main_ssl train`` of
    MeanTeacher with ``eva_main``, ``main_wsl train`` of GatedCRF on
    scribbles, ``main_nll train`` of DAST and of TriNet (2 iterations, a
    validation, the auto test stage each), and ``main_nll_clslsr`` (its
    maps against phase 25's): rc 0, the barriers through NCCL, the group
    closed, launches equal to 18 / 36 / 54 x the eval forwards;
34. profiling on phase 13's workspace: the generator's ``cli train`` (4
    iterations, a validation every 2) with ``[training] profile_dir``
    writes one trace holding exactly 2 ``train_step`` spans on the device
    lane, no validation span and no DSBN+PReLU kernel; the f32 ``cli
    test`` of the phase-4 volumes with ``[testing] profile_dir`` writes one
    trace holding one ``infer_run`` span per volume and as many DSBN+PReLU
    kernel events as launches counted, and labels equal to phase 4's; the
    spans' device time, the trace sizes, the step call under the profiler
    beside phase 12, and ``traced_device_ms`` of one ``Inferer.run``
    beside CUDA events;
35. the pipelined test stage on phase 4's workspace with 5 more volumes (8
    of 40x160x272): the f32 device-label ``cli test`` under ``profile_dir``,
    as the agent runs it (volume i+1 dispatched before volume i's fetch and
    save) and through a serial loop in the same agent (``run``, crop, save,
    one volume at a time): labels equal between the two and to phase 4's
    on its 3 volumes, 108 launches per volume and as many kernel events,
    the peak above the stage's start within phase 4's plus one volume's
    TTA accumulator; each loop's wall per volume (host clock, first
    dispatch to last save), the device's idle share from the first to the
    last kernel, the gaps between ``infer_run`` spans, the peaks and the
    host's median dispatch, fetch wait and save per volume; both loops
    again without the profiler (wall and host split, labels equal); then
    ``fpl = True`` pipelined and serial (the sorted uncertainty lists
    equal, wall per volume), ``test_batch_size = 3`` across loader batches
    (the first batch's labels equal to phase 8's), and one dispatch each of
    ``run_async``, ``run_batch_async`` and ``run_fpl_uncertainty`` under
    ``torch.cuda.set_sync_debug_mode('error')``, fetched after: none may
    wait for the card;
36. the driver entry points (``fpl_plus_torch/dryrun.py``): ``entry()``'s
    forward on the card (``[1, 2, 28, 128, 128]``, 18 launches; on a seeded
    window its logits against the same module through the plain version,
    phase 3's tolerance); the public ``dryrun_multichip(1)`` at the JAX dry
    run's shapes; then the whole four-stage pipeline at NET_CFG (2 cases
    per domain of 40x160x272, window = stride = crop [28,128,128], 4-flip
    TTA, batch 2 + 2, 2 iterations resumed to 4, a validation every 2)
    under ``[training] multihost = True`` and the ``FPLX_*`` triple of one
    process (an NCCL group of one rank per CLI run): stage 2's labels
    voxel for voxel and its FPL list (the same order, rel 1e-5) against a
    plain one-process ``cli test`` of the generator's checkpoint, launches
    equal to 18 x the eval forwards, the evaluation CSVs of stages 1 and 4
    finite, each stage's wall and the total beside the card's name and
    power limit;
37. ``precision = float16`` beyond the flagship: MeanTeacher, WSL
    EntropyMinimization, CoTeaching and ResNet18 (full width, 2 steps each)
    at f16 against the same steps at f32 (finite, losses within
    PRECISION_LOSS_RTOL, the state f32; no launch); ``cli nll_clslsr`` of
    phase 25 with phase 4's checkpoint at ``[testing] precision =
    float32`` and ``float16`` (18 launches per eval forward, the f16 maps
    against the f32 ones); ``matmul_precision`` highest,
    default, highest in one process: the TF32 flags after each, and an f32
    convolution and matmul bit-equal under a repeated value;
38. profiler sessions back to back, in the process that traced in phases
    12, 34 and 35: TRACE_PAIRS pairs of ``trace_metrics`` traces, one of a
    phase-12 f32 step and one of 6 eval forwards of a flagship window
    batch; every kernel launch call in each trace after ``start_trace``'s
    priming ones has its kernel's event (the same correlation id), and
    each inference trace holds as many
    DSBN+PReLU kernel events as launches; the least kernel start less its
    launch call's start per trace (negative where the trace's device
    clock runs behind the host's).
39. window attention (``ops/window_attention.py``, Triton, Swin UNETR's):
    the kernel against ``window_attention_reference`` at the four stage
    shapes of a batch-8 window forward of the benchmark's Swin UNETR
    (SWIN_STAGES: 343, 343, 196 and 98 tokens, 3, 6, 12 and 24 heads),
    unshifted and shifted, at f32 (and f32 with TF32 allowed), bf16 and
    f16; CUDA-event times of the kernel, of the plain version and of
    ``F.scaled_dot_product_attention`` with the bias and mask as a float
    mask (the library yardstick; the port never calls it), beside the
    bound (f32: operations over the f32 peak; bf16, f16: bytes); then the
    full-width network on a [8, 1, 32, 128, 128] batch: an eval forward
    launches the kernel 8 times (4 shifted) and agrees, TF32 off, with the
    same module in train mode under no_grad (the plain attention, no
    launch); the main path, the agent's test stage (``cli.main(['test',
    cfg])``) on 3 volumes at the benchmark's [32, 128, 128] window, with
    ``window_attention.launches`` and ``.shifted`` set to 0 just before it:
    6 eval forwards a volume, 8 launches (4 shifted) each, labels in
    {0, 1}; and the network's forward times at f32 and bf16.

Phases 4, 7, 8, 17 and 34 time each Inferer dispatch that the stage makes
(``run_async``, ``run_fpl_uncertainty``, ``run_batch_async``,
``run_passes_async``, ``run_logits``) by CUDA events recorded before the
call and when it returns, read when the stage has ended: the stream's time
from the end of the work before the dispatch to the end of its copy out,
with no wait inside the pipelined stage.

Each main-path run (phases 4, 7, 8, 13, 15, 17, 20, 23, 25-31, 33-37) sets
the launch counter to 0 just before it and reads it just after. Then it prints
one ``{"kernels": [...]}`` line and, last, the ok line. It imports nothing of the JAX package. Without
a card, or without the ``fpl_plus_torch`` package beside it, it exits
non-zero and prints no result.
"""
import contextlib
import copy
import csv
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

NET_CFG = {'net_type': 'UNet2D5_dsbn', 'num_domains': 2, 'class_num': 2,
           'in_chns': 1, 'feature_chns': [32, 64, 128, 256, 512],
           'conv_dims': [2, 2, 3, 3, 3],
           'dropout': [0.0, 0.0, 0.3, 0.4, 0.5], 'bilinear': False}
WINDOW = [28, 128, 128]
VOLUME = (40, 160, 272)
N_VOLUMES = 3
PATCH_CHUNK = 2
TTA_VARIANTS = 4
BATCH = TTA_VARIANTS * PATCH_CHUNK
FPL_PASSES = 6
FPL_BATCH = FPL_PASSES * BATCH           # the FPL pass's forward batch
SERVE_BATCH = 3                          # test_batch_size of phase 8
FOLD_VOLUME = (28, 128, 256)             # phase 6: 2 windows, one chunk
CROP_VOLUME = (40, 144, 256)             # phase 17's CenterCrop
DOMAIN = 1
SEED = 20261016
# tolerances: f32 -- the same f32 arithmetic, rsqrt/division rounded by
# another instruction; bf16 and f16 -- both round one f32 value to the
# input's type, so they differ by at most one ulp (bf16 2^-8, f16 2^-10
# relative) where the f32 values straddle a rounding boundary
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-3}
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
PRECISIONS = ('float32', 'bfloat16', 'float16')
# forward phase, f32 with TF32 off: cuDNN and the CPU sum ~20 convolution
# layers in different orders (phase 6: cuDNN at batch 48 vs batch 8)
FWD_TOL = 1e-3
# phase 6 reduction, card vs CPU on the same logits: vars_sum sums ~2 M f32
# terms in other orders; a voxel whose entropy term sits within an ulp of
# the 0.01 threshold may count on one side only
REDUCE_RTOL = 1e-4
REDUCE_COUNT_TOL = 1e-5
# phase 8, batched vs per-volume labels with TF32 off (f32 arithmetic, other
# summation orders); with TF32 on, batch 24 vs batch 8 takes other cuDNN
# algorithms whose TF32 rounding flips the near-ties that random weights
# leave between the two logits (0.99967 measured on the H100)
BATCH_AGREE = 0.9999
BATCH_AGREE_TF32 = 0.999
# phase 11, train step card vs CPU, f32 with TF32 off: the same sums in
# other orders through ~20 layers forward and back. Loss and class dice:
# absolute. A gradient: per tensor, against that tensor's max |g| plus the
# network's largest |g|: the f32 step itself is that far from exact on the
# deep tensors, whose gradients are small (against a float64 CPU step,
# tools/torch_train_step_precision.py measured on an H100: CPU f32 up to
# 9.8e-5 and the card up to 1.9e-4 of the network's max |g|, 1-2% of a deep
# tensor's own max). Running statistics: against the tensor's max |value|
STEP_LOSS_TOL = 1e-4
STEP_DICE_TOL = 1e-3
GRAD_RTOL = 5e-3
GRAD_NET_TOL = 1e-3
STATS_TOL = 1e-5
TRAIN_BATCH = 4                          # flagship: 4 + 4 crops
TRAIN_STEPS, TRAIN_WARMUP = 12, 3
REPLACES = 'fpl_plus_tpu/ops/pallas_fused.py:49'
CONVS = (torch.nn.Conv2d, torch.nn.Conv3d)
TRANSPOSED = (torch.nn.ConvTranspose2d, torch.nn.ConvTranspose3d)
SOURCE = 'fpl_plus_torch/ops/dsbn_prelu.py'

CFG = """
[dataset]
task_type = seg
root_dir = {root}
modal_num = 1
test_csv = {root}/{csv}
test_batch_size = {batch}
test_transform = {chain}
NormalizeWithMeanStd_channels = [0]
Pad_output_size = [28, 128, 128]
CenterCrop_output_size = {crop}

[network]
net_type = UNet2D5_dsbn
num_domains = 2
class_num = 2
in_chns = 1
feature_chns = [32, 64, 128, 256, 512]
conv_dims = [2, 2, 3, 3, 3]
dropout = [0.0, 0.0, 0.3, 0.4, 0.5]
bilinear = False

[training]
ckpt_save_dir = {root}/model/gen

[testing]
ckpt_mode = {mode}
domian_label = 1
output_dir = {root}/{out}
sliding_window_enable = True
sliding_window_size = [28, 128, 128]
sliding_window_stride = [28, 128, 128]
tta_mode = 1
patch_chunk = 2
precision = {precision}
{extra}
"""


def check(cond, msg):
    if not cond:
        raise RuntimeError('chip_smoke: ' + msg)


def memory_rate(name: str) -> float:
    """Device-memory bytes/s from NVIDIA's data sheets, by card name."""
    if 'H100' in name and 'PCIe' in name:
        return 2.0e12
    if 'H100' in name and 'NVL' in name:
        return 3.9e12
    if 'H200' in name:
        return 4.8e12
    return 3.35e12                       # H100 SXM (HBM3)


def cuda_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def tf32_off():
    """Convolutions and matmuls in full f32 inside the block."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags


def dsbn_shapes(batch):
    """Input shape of each of the 18 DSBN+PReLU launches of one forward of
    a ``batch``-window chunk at NET_CFG, in launch order (2D levels fold
    depth into the batch)."""
    d, h, w = WINDOW
    levels = []
    for c, dim in zip(NET_CFG['feature_chns'], NET_CFG['conv_dims']):
        levels.append((batch * d, c, h, w) if dim == 2
                      else (batch, c, d, h, w))
        d, h, w = (d, h // 2, w // 2) if dim == 2 else (d // 2, h // 2,
                                                         w // 2)
    return [levels[i] for i in (0, 1, 2, 3, 4, 3, 2, 1, 0) for _ in (1, 2)]


def random_tables(c, gen, dev):
    def t(x):
        return x.to(dev)
    return (t(torch.rand(2, c, generator=gen) + 0.5),
            t(torch.randn(2, c, generator=gen)),
            t(torch.randn(2, c, generator=gen)),
            t(torch.rand(2, c, generator=gen) + 0.5))


def conv_bias_check(x, tables, alpha, gen, dev):
    """The kernel with a convolution's bias folded in, both domains: at f32
    bit for bit the bias ``add_`` (as cuDNN's convolution adds it) followed
    by the bias-free kernel; at bf16 and f16 within ``TOL`` of the plain
    version. Returns the largest abs error against the plain version."""
    from fpl_plus_torch.ops.dsbn_prelu import (dsbn_prelu,
                                              dsbn_prelu_reference)
    cb = torch.randn(x.shape[1], generator=gen).to(dev, x.dtype)
    view = (1, -1) + (1,) * (x.dim() - 2)
    folds, worst = dsbn_prelu.bias_folds, 0.0
    for d in (0, 1):
        got = dsbn_prelu(x, *tables, d, alpha, conv_bias=cb)
        if x.dtype == torch.float32:
            want = dsbn_prelu(x.clone().add_(cb.reshape(view)), *tables, d,
                              alpha)
            check(torch.equal(got, want), 'the folded conv bias differs '
                  'from add_ + kernel at {0} domain {1}'.format(
                      tuple(x.shape), d))
        want = dsbn_prelu_reference(x, *tables, d, alpha, conv_bias=cb)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = TOL[x.dtype]
        check(bool((err <= tol + tol * want.float().abs()).all()),
              'kernel with conv bias disagrees with plain at {0} {1} domain '
              '{2}: max abs err {3}'.format(tuple(x.shape), x.dtype, d,
                                            err.max().item()))
        worst = max(worst, err.max().item())
        del got, want, err
    check(dsbn_prelu.bias_folds == folds + 2, 'bias folds not counted')
    return worst


def kernel_phase(dev, rate, batch=BATCH):
    from fpl_plus_torch.ops.dsbn_prelu import (dsbn_prelu,
                                              dsbn_prelu_reference)
    gen = torch.Generator().manual_seed(SEED + batch - BATCH)
    cuda_gen = torch.Generator(device=dev).manual_seed(SEED + batch - BATCH)
    alpha = torch.tensor([0.25], device=dev)
    shapes = sorted(set(dsbn_shapes(batch)), key=lambda s: -np.prod(s))
    ragged = [(3, 96, 7, 9, 11)] if batch == BATCH else []   # S = 693
    rows, max_err = {}, {dtype: 0.0 for dtype in DTYPES}
    for shape in shapes + ragged:
        tables = random_tables(shape[1], gen, dev)
        x32 = torch.randn(shape, generator=cuda_gen, device=dev)
        for dtype in DTYPES:
            x = x32.to(dtype)
            for d in (0, 1):
                got = dsbn_prelu(x, *tables, d, alpha)
                want = dsbn_prelu_reference(x, *tables, d, alpha)
                torch.cuda.synchronize()
                check(got.dtype == dtype and got.shape == x.shape,
                      'kernel output dtype/shape at {0}'.format(shape))
                err = (got.float() - want.float()).abs()
                tol = TOL[dtype]
                check(bool((err <= tol + tol * want.float().abs()).all()),
                      'kernel disagrees with plain at {0} {1} domain {2}: '
                      'max abs err {3}'.format(shape, dtype, d,
                                               err.max().item()))
                max_err[dtype] = max(max_err[dtype], err.max().item())
                del got, want, err
            fold_err = conv_bias_check(x, tables, alpha, gen, dev)
            max_err[dtype] = max(max_err[dtype], fold_err)
            ms = cuda_ms(lambda: dsbn_prelu(x, *tables, DOMAIN, alpha))
            bound = 2 * x.numel() * x.element_size() / rate * 1e3
            cb = torch.randn(shape[1], generator=gen).to(dev, dtype)
            view = (1, -1) + (1,) * (x.dim() - 2)
            scratch = x.clone()
            fold_ms = cuda_ms(lambda: dsbn_prelu(x, *tables, DOMAIN, alpha,
                                                 conv_bias=cb))
            two_pass_ms = cuda_ms(lambda: dsbn_prelu(
                scratch.add_(cb.reshape(view)), *tables, DOMAIN, alpha))
            rows[(shape, dtype)] = {'ms': ms, 'bound_ms': bound,
                                    'fold_ms': fold_ms,
                                    'two_pass_ms': two_pass_ms}
            print('kernel {0} {1}: {2:.4f} ms, bound {3:.4f} ms ({4:.0%}), '
                  'max abs err {5:.3g}; with the conv bias folded {6:.4f} '
                  'ms, bias add_ + kernel {7:.4f} ms'.format(
                      list(shape), str(dtype).split('.')[-1], ms, bound,
                      bound / ms, max_err[dtype], fold_ms, two_pass_ms))
            del scratch
        del x32, x
        torch.cuda.empty_cache()
    big = shapes[0]
    tables = random_tables(big[1], gen, dev)
    x32 = torch.randn(big, generator=cuda_gen, device=dev)
    g, b, m, v = (t[DOMAIN] for t in tables)
    for dtype in DTYPES:
        # the yardstick at bf16 and f16: an input of that type with the f32
        # tables (PyTorch's mixed-type batch norm), the slope in the
        # input's type
        x, a = x32.to(dtype), alpha.to(dtype)
        row = rows[(big, dtype)]
        row['plain_ms'] = cuda_ms(lambda: dsbn_prelu_reference(
            x, *tables, DOMAIN, alpha))
        row['yard_ms'] = cuda_ms(lambda: F.prelu(
            F.batch_norm(x, m, v, g, b, False, 0.0, 1e-5), a))
        print('kernel {0} {1}: plain {2:.4f} ms, F.batch_norm+F.prelu '
              '{3:.4f} ms'.format(list(big), str(dtype).split('.')[-1],
                                  row['plain_ms'], row['yard_ms']))
    return (rows, max_err, big, rows[(big, torch.float32)]['plain_ms'],
            rows[(big, torch.float32)]['yard_ms'])


def init_random_(net, seed):
    """Seeded weights at a trained net's scales: He-normal convolution and
    dense weights, (DS)BN affine near identity, running statistics away
    from 0/1."""
    gen = torch.Generator().manual_seed(seed)
    transposed = {n + '.weight' for n, m in net.named_modules()
                  if isinstance(m, TRANSPOSED)}
    with torch.no_grad():
        for name, p in list(net.named_parameters()) + list(
                net.named_buffers()):
            if name.endswith('num_batches_tracked'):
                continue
            if name.endswith('running_var'):
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5)
            elif name.endswith('running_mean'):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
            elif 'relu_' in name:
                p.fill_(0.25)
            elif name.endswith('weight') and p.dim() == 1:   # (DS)BN scale
                p.copy_(torch.rand(p.shape, generator=gen) * 0.4 + 0.8)
            elif name.endswith('bias'):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
            else:        # convolution, transposed-convolution, dense weights
                fan_in = (p.shape[0] if name in transposed
                          else p[0].numel())
                p.copy_(torch.randn(p.shape, generator=gen)
                        * (2.0 / fan_in) ** 0.5)


@contextlib.contextmanager
def counting_macs(net):
    """Multiply-accumulates of the convolutions and dense layers of the
    forwards in the block, counted from the module shapes: each output
    element of a conv is in_channels x taps MACs (a dense layer: in
    features); a k=2/s=2 transposed conv spreads each input element over
    out_channels x taps outputs once. An eval forward runs a UNet2D5
    ``ConvBlockND``'s convolutions without calling their modules (their
    bias goes to the DSBN kernel), so those are counted at the DSBN that
    follows each, whose input has the convolution's output shape."""
    from fpl_plus_torch.models.unet2d5_dsbn import ConvBlockND
    macs = [0]

    def count(mod, args, out):
        n = args[0].numel() if isinstance(mod, TRANSPOSED) else out.numel()
        macs[0] += n * mod.weight[0].numel()

    def count_before(conv):
        def hook(mod, args):
            macs[0] += args[0].numel() * conv.weight[0].numel()
        return hook

    followed = {}                        # DSBN -> the convolution before it
    for block in net.modules():
        if isinstance(block, ConvBlockND):
            for conv, bn, _ in block._names:
                followed[getattr(block, bn)] = getattr(block, conv)
    skip = set(map(id, followed.values()))
    hooks = [m.register_forward_hook(count) for m in net.modules()
             if isinstance(m, CONVS + TRANSPOSED + (torch.nn.Linear,))
             and id(m) not in skip]
    hooks += [bn.register_forward_pre_hook(count_before(conv))
              for bn, conv in followed.items()]
    try:
        yield macs
    finally:
        for h in hooks:
            h.remove()


def forward_phase(dev):
    from fpl_plus_torch.models.dsbn import DomainBatchNorm
    from fpl_plus_torch.models.registry import create_network
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    net = create_network(NET_CFG).eval()
    init_random_(net, SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    x = torch.randn((1, 1) + tuple(WINDOW), generator=gen)
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(tuple(args[0].shape)))
        for m in net.modules() if isinstance(m, DomainBatchNorm)]
    with tf32_off(), torch.inference_mode():
        with counting_macs(net) as macs:
            want = net(x, DOMAIN)
        for h in hooks:
            h.remove()
        check(seen == dsbn_shapes(1), 'DSBN launch shapes {0} != {1}'.format(
            seen, dsbn_shapes(1)))
        before = dsbn_prelu.launches
        got = copy.deepcopy(net).to(dev)(x.to(dev), DOMAIN).cpu()
        check(dsbn_prelu.launches - before == 18,
              'forward launched the kernel {0} times, not 18'.format(
                  dsbn_prelu.launches - before))
    check(bool(torch.isfinite(got).all()), 'non-finite logits on the card')
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print('forward {0} f32 TF32-off: card vs CPU max abs err {1:.3g} '
          '(|logit| max {2:.3g}, tolerance {3} x max(1, |logit|))'.format(
              list(x.shape), err, scale, FWD_TOL))
    check(err <= FWD_TOL * max(1.0, scale), 'forward disagrees')
    print('network: {0:.3f} GMAC per window forward (counted from the '
          'module shapes)'.format(macs[0] / 1e9))
    return net, macs[0]


def write_volumes(root, cases, rs):
    """Seeded 40x160x272 volumes ``img/case<i>.nii.gz`` for ``cases`` (a
    bright block in noise); returns their names."""
    from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_nifti
    geom = ImageGeometry(origin=(0., 0., 0.), spacing=(0.4, 0.4, 1.5),
                         direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
    os.makedirs(os.path.join(root, 'img'), exist_ok=True)
    names = []
    for case in cases:
        vol = rs.normal(100.0, 20.0, size=VOLUME).astype(np.float32)
        vol[12:28, 60:100, 100:170] += 80.0
        name = 'img/case{0}.nii.gz'.format(case)
        write_nifti(NiftiImage(vol, geom), os.path.join(root, name))
        names.append(name)
    return names


def write_csv(root, csv, names):
    with open(os.path.join(root, csv), 'w') as f:
        f.write('image\n' + '\n'.join(names) + '\n')


def write_workspace(root, net):
    names = write_volumes(root, range(N_VOLUMES), np.random.RandomState(SEED))
    write_csv(root, 'target_test.csv', names)
    ckpt_dir = os.path.join(root, 'model', 'gen')
    os.makedirs(ckpt_dir)
    torch.save({'iteration': 100, 'valid_pred': 0.0,
                'model_state_dict': net.state_dict()},
               os.path.join(ckpt_dir, 'gen_100.pt'))
    with open(os.path.join(ckpt_dir, 'gen_latest.txt'), 'w') as f:
        f.write('100')
    return names


@contextlib.contextmanager
def timed_method(cls, name, sink):
    """Record the CUDA-event ms of every call of ``cls.name`` in ``sink``."""
    orig = getattr(cls, name)

    def timed(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(self, *args, **kwargs)
        end.record()
        end.synchronize()
        sink.append(start.elapsed_time(end))
        return out

    setattr(cls, name, timed)
    try:
        yield sink
    finally:
        setattr(cls, name, orig)


def start_peak():
    """Reset the card's peak allocation; returns what is allocated now, the
    base that a stage's peak is read above."""
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


@contextlib.contextmanager
def timed_dispatch(cls, name, sink):
    """Record in ``sink``, when the block ends, the CUDA-event ms of every
    dispatch through ``cls.name`` (an Inferer entry): from an event
    recorded before the call to one recorded when it returns, its work and
    its result's copy out enqueued. Nothing waits inside the block, so a
    pipelined caller keeps its schedule; each time is the stream's, from
    the end of the work before the dispatch to the end of its copy out."""
    orig = getattr(cls, name)
    events = []

    def timed(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(self, *args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    setattr(cls, name, timed)
    try:
        yield sink
    finally:
        setattr(cls, name, orig)
        torch.cuda.synchronize()
        sink.extend(start.elapsed_time(end) for start, end in events)


@contextlib.contextmanager
def timed_function(module, name, sink):
    """Record the host seconds of every call of ``module.name`` in
    ``sink`` (for host-side work such as the evaluation)."""
    orig = getattr(module, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        sink.append(time.perf_counter() - t0)
        return out

    setattr(module, name, timed)
    try:
        yield sink
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def counting_forwards():
    """Count the eval-mode network forwards (calls of a UNet2D5DSBN) in the
    block: the forwards that reach the kernel (train-mode forwards use
    batch statistics)."""
    from fpl_plus_torch.models.unet2d5_dsbn import UNet2D5DSBN
    n = [0]

    def count(module, args, out):
        if isinstance(module, UNet2D5DSBN) and not module.training:
            n[0] += 1

    hook = torch.nn.modules.module.register_module_forward_hook(count)
    try:
        yield n
    finally:
        hook.remove()


def write_cfg(root, tag, precision='float32', batch=1, extra='', mode=0,
              chain='[NormalizeWithMeanStd, Pad]', csv='target_test.csv'):
    cfg = os.path.join(root, tag + '.cfg')
    with open(cfg, 'w') as f:
        f.write(CFG.format(root=root, out='out_' + tag, precision=precision,
                           batch=batch, extra=extra, mode=mode, chain=chain,
                           crop=list(CROP_VOLUME), csv=csv))
    return cfg


def serving_phase(root, net):
    from fpl_plus_torch import cli
    from fpl_plus_torch.engine.infer import Inferer, window_grid
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    names = write_workspace(root, net)
    windows = len(window_grid(VOLUME, WINDOW, WINDOW))   # 12
    fwd_per_volume = -(-windows // PATCH_CHUNK)
    results = {}
    for precision in PRECISIONS:
        out = 'out_' + precision
        cfg = write_cfg(root, precision, precision)
        vol_ms = []
        with timed_dispatch(Inferer, 'run_async', vol_ms), \
                counting_forwards() as forwards:
            base = start_peak()
            dsbn_prelu.launches = 0      # the main path's count starts here
            dsbn_prelu.bias_folds = 0
            rc = cli.main(['test', cfg])
            launches = dsbn_prelu.launches
            peak = torch.cuda.max_memory_allocated() - base
        check(rc == 0, 'test stage rc {0}'.format(rc))
        check(dsbn_prelu.bias_folds == launches,
              '{0} conv bias folds for {1} launches'.format(
                  dsbn_prelu.bias_folds, launches))
        check(forwards[0] == N_VOLUMES * fwd_per_volume,
              '{0} forwards, expected {1}'.format(
                  forwards[0], N_VOLUMES * fwd_per_volume))
        check(launches == 18 * forwards[0],
              '{0} kernel launches for {1} forwards'.format(launches,
                                                            forwards[0]))
        labels = []
        for name in names:
            path = os.path.join(root, out, 'gen_target_test',
                                os.path.basename(name))
            lab = load_image_as_nd_array(path)['data_array']
            check(lab.shape == (1,) + VOLUME and lab.dtype == np.uint8,
                  'label {0} {1}'.format(lab.shape, lab.dtype))
            check(set(np.unique(lab).tolist()) <= {0, 1},
                  'labels outside {0, 1}')
            labels.append(lab)
        results[precision] = {'vol_ms': vol_ms, 'launches': launches,
                              'forwards': forwards[0], 'labels': labels,
                              'peak': peak}
        print('serving {0}: {1} volumes through fpl_plus_torch.cli, '
              'Inferer.run_async ms per volume (CUDA events, dispatch to its '
              'copy out) {2}, {3} forwards, {4} kernel launches (each with '
              'its conv bias folded in), peak device memory above the '
              'allocation before the stage {5:.3f} GiB, foreground share {6:.4f}'.format(
                  precision, len(labels),
                  ['{0:.2f}'.format(t) for t in vol_ms], forwards[0],
                  launches, peak / 2 ** 30,
                  float(np.mean([lb.mean() for lb in labels]))))
    for precision in PRECISIONS[1:]:
        results[precision]['agree_f32'] = float(np.mean([
            np.mean(a == b) for a, b in zip(results['float32']['labels'],
                                            results[precision]['labels'])]))
    print('serving: labels agree with f32 on {0!r} of voxels at bf16, '
          '{1!r} at f16'.format(results['bfloat16']['agree_f32'],
                                results['float16']['agree_f32']))
    return results, names, fwd_per_volume


def fold_phase(dev, net):
    """6 folded MC-dropout passes against 6 sequential ones on the card
    (TF32 off), then the FPL reduction of those logits, card vs CPU."""
    from fpl_plus_torch.engine.infer import Inferer, fpl_uncertainty_reduce
    cfg = {'sliding_window_enable': True, 'sliding_window_size': WINDOW,
           'sliding_window_stride': WINDOW, 'tta_mode': 1,
           'patch_chunk': PATCH_CHUNK, 'output_mode': 'logits'}
    net_dev = copy.deepcopy(net).to(dev).eval()
    image = np.random.RandomState(SEED + 2).normal(
        size=(1, 1) + FOLD_VOLUME).astype(np.float32)
    seeds = np.random.SeedSequence(SEED).generate_state(FPL_PASSES)

    def gens():
        return [torch.Generator(dev).manual_seed(int(x)) for x in seeds]

    def mc(generators):
        return functools.partial(net_dev, domain_label=DOMAIN,
                                 dropout_generators=generators)

    inferer = Inferer(cfg, dev)
    with tf32_off():
        folded = inferer.run_passes(mc(gens()), image, FPL_PASSES)
        seq = [inferer.run(mc([g]), image) for g in gens()]
    del net_dev
    check(folded.shape == (FPL_PASSES, 2) + FOLD_VOLUME,
          'folded shape {0}'.format(folded.shape))
    check(bool(np.isfinite(folded).all()), 'non-finite folded logits')
    err = max(float(np.abs(folded[i] - seq[i][0]).max())
              for i in range(FPL_PASSES))
    scale = float(np.abs(folded).max())
    spread = float(np.abs(folded[0] - folded[1]).mean())
    print('fold {0} passes x {1}: folded vs sequential max abs err {2:.3g} '
          '(|logit| max {3:.3g}, tolerance {4} x max(1, |logit|)); passes 0 '
          'and 1 differ by {5:.3g} on average'.format(
              FPL_PASSES, list(FOLD_VOLUME), err, scale, FWD_TOL, spread))
    check(err <= FWD_TOL * max(1.0, scale), 'fold disagrees with sequential')
    check(spread > 0, 'dropout passes are identical')

    lo, up = [2, 5, 3], [1, 0, 7]
    logits = torch.from_numpy(folded)
    (v_dev, b_dev), (v_cpu, b_cpu) = (
        (float(v), int(b)) for v, b in (
            fpl_uncertainty_reduce(logits.to(dev), lo, up),
            fpl_uncertainty_reduce(logits, lo, up)))
    n_sel = int(np.prod([s - a - b for s, a, b in zip(FOLD_VOLUME, lo, up)]))
    print('reduce: vars_sum card {0!r} CPU {1!r}; boundary card {2} CPU {3} '
          'of {4} voxels'.format(v_dev, v_cpu, b_dev, b_cpu, n_sel))
    check(np.isfinite(v_dev) and v_dev > 0, 'vars_sum {0}'.format(v_dev))
    check(abs(v_dev - v_cpu) <= REDUCE_RTOL * abs(v_cpu),
          'vars_sum card {0} vs CPU {1}'.format(v_dev, v_cpu))
    check(abs(b_dev - b_cpu) <= max(1, REDUCE_COUNT_TOL * n_sel),
          'boundary card {0} vs CPU {1}'.format(b_dev, b_cpu))
    return {'err': err, 'vars_sum': (v_dev, v_cpu),
            'boundary': (b_dev, b_cpu)}


def fpl_phase(root, dev, names, fwd_per_volume):
    """The ``fpl = True`` stage through the CLI at f32, bf16 and f16."""
    from fpl_plus_torch import cli
    from fpl_plus_torch.engine.infer import Inferer
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    results = {}
    for precision in PRECISIONS:
        npy = os.path.join(root, 'fpl_{0}.npy'.format(precision))
        cfg = write_cfg(root, 'fpl_' + precision, precision, extra=(
            'fpl = True\nfpl_uncertainty_sorted = ' + npy))
        ms = []
        with timed_dispatch(Inferer, 'run_fpl_uncertainty', ms), \
                counting_forwards() as forwards:
            torch.cuda.reset_peak_memory_stats(dev)
            dsbn_prelu.launches = 0      # the main path's count starts here
            dsbn_prelu.bias_folds = 0
            rc = cli.main(['test', cfg])
            launches = dsbn_prelu.launches
            peak = torch.cuda.max_memory_allocated(dev)
        check(rc == 0, 'fpl stage rc {0}'.format(rc))
        check(dsbn_prelu.bias_folds == launches,
              '{0} conv bias folds for {1} fpl launches'.format(
                  dsbn_prelu.bias_folds, launches))
        check(forwards[0] == N_VOLUMES * fwd_per_volume,
              '{0} fpl forwards, expected {1}'.format(
                  forwards[0], N_VOLUMES * fwd_per_volume))
        check(launches == 18 * forwards[0],
              '{0} kernel launches for {1} fpl forwards'.format(
                  launches, forwards[0]))
        entries = np.load(npy, allow_pickle=True)
        values = [float(np.asarray(e[0]).reshape(-1)[0]) for e in entries]
        check(sorted(str(e[1]) for e in entries) == sorted(names),
              'fpl names {0}'.format([str(e[1]) for e in entries]))
        check(all(np.isfinite(values)) and values == sorted(values),
              'fpl values {0}'.format(values))
        results[precision] = {'vol_ms': ms, 'launches': launches,
                              'forwards': forwards[0], 'peak': peak,
                              'values': values, 'npy': npy,
                              'by_name': {str(e[1]): v for e, v in
                                          zip(entries, values)}}
        print('fpl {0}: {1} volumes through fpl_plus_torch.cli, '
              'run_fpl_uncertainty ms per volume (CUDA events, dispatch to '
              'its copy out) {2}, {3} forwards of batch '
              '{4}, {5} kernel launches (each with its conv bias folded in), '
              'peak device memory {6:.2f} GiB, uncertainties {7}'.format(
                  precision, len(values), ['{0:.2f}'.format(t) for t in ms],
                  forwards[0], FPL_BATCH, launches, peak / 2 ** 30, values))
    f32 = results['float32']['by_name']
    for precision in PRECISIONS[1:]:
        r = results[precision]
        r['same_order'] = (sorted(f32, key=f32.get)
                           == sorted(r['by_name'], key=r['by_name'].get))
        r['rel_f32'] = max(abs(r['by_name'][n] / f32[n] - 1) for n in f32)
        print('fpl {0} against f32: the same order {1}, uncertainties within '
              'rel {2!r}'.format(precision, r['same_order'], r['rel_f32']))
    return results


def batched_phase(root, labels_f32, names, fwd_per_volume):
    """``test_batch_size = 3`` serving through the CLI: twice at the
    default settings (timed; the first call meets cuDNN's new batch size),
    labels against phase 4's; then, with TF32 off, batched against
    per-volume labels to ``BATCH_AGREE``."""
    from fpl_plus_torch import cli
    from fpl_plus_torch.engine.infer import Inferer
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu

    def stage(tag, batch, extra=''):
        cfg = write_cfg(root, tag, batch=batch, extra=extra)
        ms = []
        with timed_dispatch(Inferer, 'run_batch_async', ms), \
                counting_forwards() as forwards:
            dsbn_prelu.launches = 0      # the main path's count starts here
            rc = cli.main(['test', cfg])
            launches = dsbn_prelu.launches
        check(rc == 0, '{0} stage rc {1}'.format(tag, rc))
        labels = [load_image_as_nd_array(os.path.join(
            root, 'out_' + tag, 'gen_target_test', os.path.basename(n)))[
            'data_array'] for n in names]
        if batch > 1:
            check(forwards[0] == fwd_per_volume,
                  '{0} batched forwards, expected {1}'.format(
                      forwards[0], fwd_per_volume))
            check(launches == 18 * forwards[0],
                  '{0} kernel launches for {1} batched forwards'.format(
                      launches, forwards[0]))
        return {'ms': ms[0] / N_VOLUMES if ms else None,
                'launches': launches, 'forwards': forwards[0],
                'labels': labels}

    def agree(a, b):
        return [float(np.mean(x == y)) for x, y in zip(a, b)]

    runs = []
    for rep in range(2):
        r = stage('batch{0}'.format(rep), SERVE_BATCH)
        r['agree'] = agree(r['labels'], labels_f32)
        check(min(r['agree']) >= BATCH_AGREE_TF32,
              'batched labels agree with per-volume on {0}'.format(
                  r['agree']))
        runs.append(r)
        print('batched {0}: test_batch_size {1}, run_batch_async {2:.2f} ms per '
              'volume, {3} forwards of batch {4}, {5} kernel launches, '
              'labels agree with per-volume (TF32) on {6}'.format(
                  rep, SERVE_BATCH, r['ms'], r['forwards'],
                  SERVE_BATCH * BATCH, r['launches'], r['agree']))
    with tf32_off():             # the stages' matmul_precision = highest
        highest = 'matmul_precision = highest'
        ref = stage('single_f32', 1, highest)
        r = stage('batch_f32', SERVE_BATCH, highest)
    r['agree'] = agree(r['labels'], ref['labels'])
    print('batched TF32 off: {0} forwards, {1} kernel launches, labels '
          'agree with per-volume (TF32 off) on {2}'.format(
              r['forwards'], r['launches'], r['agree']))
    check(min(r['agree']) >= BATCH_AGREE,
          'batched labels (TF32 off) agree with per-volume on {0}'.format(
              r['agree']))
    runs.append(r)
    return runs


def tools_phase(root, fpl):
    """``python -m fpl_plus_torch.fpl`` pixel-weight and image-weight on
    the stage outputs (host tools; run from the checkout's root)."""
    from fpl_plus_torch.io.image_io import load_image_as_nd_array

    def tool(*args):
        r = subprocess.run([sys.executable, '-m', 'fpl_plus_torch.fpl']
                           + list(args), cwd=REPO, capture_output=True,
                           text=True, timeout=300)
        check(r.returncode == 0, 'fpl tool {0}: {1}'.format(
            args[0], r.stderr[-2000:]))

    labels = {p: os.path.join(root, 'out_' + p, 'gen_target_test')
              for p in ('float32', 'bfloat16')}
    pw = os.path.join(root, 'pixel_weight')
    tool('pixel-weight', '--pseudo-target', labels['float32'],
         '--pseudo-fake-source', labels['bfloat16'], '--output', pw)
    for name in sorted(os.listdir(labels['float32'])):
        w = load_image_as_nd_array(os.path.join(pw, name))['data_array']
        a, b = (load_image_as_nd_array(os.path.join(labels[p], name))[
            'data_array'] for p in ('float32', 'bfloat16'))
        check(bool(np.array_equal(w, np.where(a != b, 0.5, 1.0))),
              'pixel weights of {0}'.format(name))
    out_csv = os.path.join(root, 'train_weighted.csv')
    tool('image-weight', '--uncertainty', fpl['float32']['npy'],
         '--output-csv', out_csv, '--image-dir', os.path.join(root, 'img'),
         '--pseudo-label-dir', labels['float32'], '--pixel-weight-dir', pw)
    with open(out_csv, newline='') as f:
        rows = list(csv.reader(f))
    check(rows[0] == ['image', 'label', 'pixel_weight', 'image_weight'],
          'csv header {0}'.format(rows[0]))
    check(len(rows) == 1 + N_VOLUMES, 'csv rows {0}'.format(len(rows)))
    for row in rows[1:]:
        check(all(os.path.isfile(p) for p in row[:3]),
              'csv names missing files: {0}'.format(row))
        check(0.01 <= float(row[3]) <= 1.01 + 1e-9,
              'image weight {0}'.format(row[3]))
    print('tools: pixel-weight maps for {0} volumes, weighted train csv '
          'image weights {1}'.format(N_VOLUMES, [r[3] for r in rows[1:]]))


def grad_refusal_phase(dev):
    """The kernel has no backward: its wrapper raises on the card when
    grad mode is on and an input requires grad, and runs under
    ``torch.no_grad()``."""
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    gen = torch.Generator().manual_seed(SEED + 3)
    tables = [t.requires_grad_() for t in random_tables(8, gen, dev)]
    alpha = torch.tensor([0.25], device=dev, requires_grad=True)
    x = torch.randn((2, 8, 4, 16, 16), device=dev)
    try:
        dsbn_prelu(x, *tables, DOMAIN, alpha)
    except RuntimeError as exc:
        refused = 'no backward' in str(exc)
    else:
        refused = False
    check(refused, 'dsbn_prelu returned a tensor without a gradient path')
    bias = torch.zeros(8, device=dev, requires_grad=True)
    try:
        dsbn_prelu(x, *(t.detach() for t in tables), DOMAIN, alpha.detach(),
                   conv_bias=bias)
    except RuntimeError as exc:
        refused = 'no backward' in str(exc)
    else:
        refused = False
    check(refused, 'dsbn_prelu took a conv bias that requires grad')
    with torch.no_grad():
        y = dsbn_prelu(x, *tables, DOMAIN, alpha)
    torch.cuda.synchronize()
    check(y.shape == x.shape, 'no_grad call')
    print('grad refusal: the kernel raises under autograd (a conv bias '
          'that requires grad too) and runs under torch.no_grad()')


def train_inputs(gen, batch, device):
    """One domain's train batch at the flagship crop: image, one-hot
    labels, binary pixel weights scaled per sample, image weights."""
    x = torch.randn((batch, 1) + tuple(WINDOW), generator=gen)
    y = (x[:, 0] > 0.5).long()
    scale = torch.rand((batch, 1, 1, 1, 1), generator=gen) * 0.5 + 0.5
    keep = (torch.rand((batch, 1) + tuple(WINDOW), generator=gen) > 0.2)
    out = {'image': x,
           'label_prob': F.one_hot(y, 2).movedim(-1, 1).float(),
           'pixel_weight': keep.float() * scale,
           'image_weight': torch.rand(batch, generator=gen) * 0.5 + 0.5}
    return {k: v.to(device) for k, v in out.items()}


def make_step(net, precision=None):
    from fpl_plus_torch.engine.optim import create_optimizer
    from fpl_plus_torch.engine.train import JointTrainStep
    from fpl_plus_torch.losses import create_loss_calculator
    cfg = {'optimizer': 'Adam', 'learning_rate': 1e-4, 'weight_decay': 0.0,
           'loss_type': 'DiceLoss'}
    return JointTrainStep(net.train(), create_loss_calculator(
        {'training': cfg}), create_optimizer(cfg, net.parameters()),
        num_domains=2, fpl_uda=True, compute_dtype=precision)


def train_step_phase(dev):
    """One joint step, card vs CPU, full width, dropout 0, TF32 off; it
    folds no convolution's bias into the DSBN kernel."""
    from fpl_plus_torch.models.registry import create_network
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    net = create_network(dict(NET_CFG, dropout=[0.0] * 5))
    init_random_(net, SEED + 4)
    net_dev = copy.deepcopy(net).to(dev)
    gen = torch.Generator().manual_seed(SEED + 5)
    batches = [train_inputs(gen, 1, 'cpu') for _ in range(2)]
    folds = dsbn_prelu.bias_folds
    with tf32_off():
        got = make_step(net_dev)([{k: v.to(dev) for k, v in b.items()}
                                  for b in batches], [None, None])
        torch.cuda.synchronize()
    check(dsbn_prelu.bias_folds == folds, 'a train step folded {0} conv '
          'biases'.format(dsbn_prelu.bias_folds - folds))
    want = make_step(net)(batches, [None, None])
    loss_err = abs(float(got['loss']) - float(want['loss']))
    dice_err = max(float((got[k].cpu() - want[k]).abs().max())
                   for k in ('class_dice_0', 'class_dice_1'))
    grads = {k: p.grad for k, p in net.named_parameters()}
    top = max(float(g.abs().max()) for g in grads.values())
    worst, worst_name, rel_max = 0.0, None, 0.0
    for name, p in net_dev.named_parameters():
        err = float((p.grad.cpu() - grads[name]).abs().max())
        g_max = float(grads[name].abs().max())
        ratio = err / (GRAD_RTOL * g_max + GRAD_NET_TOL * top)
        if g_max > 1e-3 * top:
            rel_max = max(rel_max, err / g_max)
        if ratio > worst:
            worst, worst_name = ratio, name
    stats_err = 0.0
    ref = net.state_dict()
    for name, t in net_dev.state_dict().items():
        if name.endswith(('running_mean', 'running_var')):
            e = float((t.cpu() - ref[name]).abs().max()
                      / ref[name].abs().max())
            stats_err = max(stats_err, e)
    print('train step card vs CPU (full width, 1+1 crops, TF32 off): loss '
          '{0!r} vs {1!r} (abs err {2:.3g}, tolerance {3}); class dice max '
          'abs err {4:.3g} (tolerance {5}); gradients: max abs err / '
          'tensor max |g| {6:.3g} over tensors with |g| above 1e-3 of the '
          'network max, worst tensor {7} at {8:.3g} of its tolerance '
          '({9} x tensor max |g| + {10} x network max |g| {11:.3g}); DSBN '
          'running statistics max abs err / tensor max {12:.3g} '
          '(tolerance {13})'.format(
              float(got['loss']), float(want['loss']), loss_err,
              STEP_LOSS_TOL, dice_err, STEP_DICE_TOL, rel_max, worst_name,
              worst, GRAD_RTOL, GRAD_NET_TOL, top, stats_err, STATS_TOL))
    check(loss_err <= STEP_LOSS_TOL, 'train step loss disagrees')
    check(dice_err <= STEP_DICE_TOL, 'train step dice disagrees')
    check(worst <= 1.0, 'train step gradient {0} disagrees'.format(
        worst_name))
    check(stats_err <= STATS_TOL, 'DSBN running statistics disagree')
    return {'loss_err': loss_err, 'grad_rel': rel_max, 'grad_worst': worst,
            'stats_err': stats_err}


def train_batches(dev):
    """Phase 12's batch: 4 + 4 seeded flagship crops on ``dev``."""
    gen = torch.Generator().manual_seed(SEED + 6)
    return [train_inputs(gen, TRAIN_BATCH, dev) for _ in range(2)]


def timed_train_phase(dev, net, macs):
    """The flagship joint step at f32 (TF32, PyTorch's default), bf16 and
    f16: median CUDA-event ms over TRAIN_STEPS steps after TRAIN_WARMUP,
    peak device memory, the losses against f32's; then the share of
    gradient entries that are exactly zero at each type
    (``zero_grad_shares``) and the step's batch-norm kernels
    (``norm_kernels``)."""
    batches = train_batches(dev)
    # forward, input-gradient and weight-gradient convolutions: 3 x the
    # forward's 2 x MACs, per window, 2 x TRAIN_BATCH windows
    tflop = 3 * 2 * macs * 2 * TRAIN_BATCH / 1e12
    results = {}
    for precision in PRECISIONS:
        step, draws = phase12_step(dev, net, precision)
        torch.cuda.reset_peak_memory_stats(dev)
        ms, losses = [], []
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step(batches, draws())
            end.record()
            end.synchronize()
            losses.append(float(m['loss']))
            if i >= TRAIN_WARMUP:
                ms.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        med = float(np.median(ms))
        check(all(np.isfinite(losses)), 'non-finite train loss')
        results[precision] = {'ms': med, 'ms_all': ms, 'peak_gib': peak,
                              'losses': losses}
        print('train step {0}: batch {1}+{1} crops {2}, median {3:.2f} ms '
              'per step over {4} steps (min {5:.2f}, max {6:.2f}), peak '
              'device memory {7:.2f} GiB, {8:.2f} TFLOP per step, {9:.1f} '
              'TFLOP/s; losses {10:.4f} -> {11:.4f}'.format(
                  precision, TRAIN_BATCH, WINDOW, med, len(ms), min(ms),
                  max(ms), peak, tflop, tflop / med * 1e3, losses[0],
                  losses[-1]))
        del step
        torch.cuda.empty_cache()
    f32 = np.asarray(results['float32']['losses'])
    for precision in PRECISIONS[1:]:
        rel = np.abs(np.asarray(results[precision]['losses']) / f32 - 1)
        results[precision]['loss_rel_f32'] = float(rel.max())
        print('train step {0}: losses over the {1} steps against f32 within '
              'rel {2!r} (step by step {3})'.format(
                  precision, len(f32), float(rel.max()),
                  ['{0:.2e}'.format(r) for r in rel]))
    results['tflop'] = tflop
    results['zero_grad'] = zero_grad_shares(dev, net, batches)
    results['norm_kernels'] = norm_kernels(dev, net, batches)
    return results


F16_TINY = 2.0 ** -24          # f16's smallest subnormal
F16_NORMAL = 2.0 ** -14        # f16's smallest normal number


def phase12_step(dev, net, precision):
    """A fresh joint step of a copy of ``net`` at ``precision``, and a
    function that returns phase 12's dropout generators of the next step
    (one per domain), in phase 12's order."""
    from fpl_plus_torch.utils.precision import resolve_dtype
    step = make_step(copy.deepcopy(net).to(dev), resolve_dtype(precision))
    seeds = iter(np.random.SeedSequence([SEED, 7]).generate_state(
        2 * (TRAIN_STEPS + TRAIN_WARMUP)))
    return step, lambda: [[torch.Generator(dev).manual_seed(int(next(seeds)))]
                          for _ in range(2)]


def first_step(dev, net, batches, precision, hook=None):
    """``phase12_step`` run once on ``batches``; ``hook``: a forward hook
    on the network during that step."""
    step, draws = phase12_step(dev, net, precision)
    handle = None if hook is None else step.module.register_forward_hook(
        hook)
    try:
        step(batches, draws())
    finally:
        if handle is not None:
            handle.remove()
    return step


def logit_grads(sink):
    """A forward hook that appends, for each train-mode output, the count
    of its gradient's entries that are exactly zero, of those that are not
    zero but under f16's smallest subnormal and under its smallest normal
    number, and of all its entries: the gradient that reaches the
    network's output in its compute type (the cast back to f32 rounds it
    to that type on the way back)."""
    def tail(g):
        nonzero = g != 0
        sink.append((int((~nonzero).sum()),
                     int((nonzero & (g.abs() < F16_TINY)).sum()),
                     int((nonzero & (g.abs() < F16_NORMAL)).sum()),
                     g.numel()))

    def hook(module, args, out):
        if out.requires_grad:
            out.register_hook(tail)
    return hook


def zero_grad_shares(dev, net, batches):
    """(12b) The share of gradient entries that are exactly zero after
    one flagship step at each type from the same weights, batch and
    dropout draws: f16 gradients that underflow (the JAX package does no
    loss scaling, and neither does the port)."""
    out = {}
    for precision in PRECISIONS:
        heads = []
        step = first_step(dev, net, batches, precision, logit_grads(heads))
        grads = [p.grad for p in step.module.parameters()]
        zeros = sum(int((g == 0).sum()) for g in grads)
        total = sum(g.numel() for g in grads)
        whole = sum(1 for g in grads if not bool(g.any()))
        check(all(bool(torch.isfinite(g).all()) for g in grads),
              'non-finite {0} gradient'.format(precision))
        check(len(heads) == 2, '{0} logit gradients seen'.format(len(heads)))
        z, tiny, sub, n = (sum(h[i] for h in heads) for i in range(4))
        out[precision] = {'zero_share': zeros / total, 'zero': zeros,
                          'entries': total, 'zero_tensors': whole,
                          'logit_zero_share': z / n,
                          'logit_below_2m24_share': tiny / n,
                          'logit_below_2m14_share': sub / n}
        print('train step {0}: {1} of {2} gradient entries exactly zero '
              '({3!r}), {4} of {5} tensors all zero; the logits\' '
              'gradient: {6!r} of its entries exactly zero, {7!r} not zero '
              'but under 2^-24, {8!r} not zero but under 2^-14'.format(
                  precision, zeros, total, zeros / total, whole,
                  len(grads), z / n, tiny / n, sub / n))
        del step
        torch.cuda.empty_cache()
    return out


def norm_kernels(dev, net, batches):
    """(12c) The batch-norm kernels one flagship step launches at each
    type, named from a ``torch.profiler`` trace of the second step of a
    fresh step object: name, launches, device ms, and their share of the
    step's kernel time."""
    from fpl_plus_torch.utils import trace_metrics
    os.makedirs(os.path.join(REPO, 'build'), exist_ok=True)
    out = {}
    for precision in PRECISIONS:
        step = first_step(dev, net, batches, precision)
        gens = [[torch.Generator(dev).manual_seed(SEED + 8 + d)]
                for d in (0, 1)]
        with tempfile.TemporaryDirectory(dir=os.path.join(
                REPO, 'build')) as trace_dir:
            trace_metrics.start_trace(trace_dir, dev)
            try:
                step(batches, gens)
            finally:
                trace_metrics.stop_trace()
            events = [e for e in trace_metrics.trace_events(trace_dir)
                      if e.get('ph') == 'X' and e.get('cat') == 'kernel'
                      and trace_metrics.PRIME_KERNEL not in e['name']]
        total = sum(float(e['dur']) for e in events)
        norms = {}
        for e in events:
            low = e['name'].lower()
            if 'norm' in low or 'bn_' in low or 'welford' in low:
                n, us = norms.get(e['name'], (0, 0.0))
                norms[e['name']] = (n + 1, us + float(e['dur']))
        check(events and norms, '{0} step: {1} kernels, no batch-norm '
              'kernel in the trace'.format(precision, len(events)))
        share = sum(us for _, us in norms.values()) / total
        out[precision] = {'kernels': {k: [n, us / 1e3]
                                      for k, (n, us) in norms.items()},
                          'share': share, 'kernel_ms': total / 1e3}
        print('train step {0}: batch-norm kernels {1!r} of {2:.2f} ms of '
              'kernels in the step:'.format(precision, share, total / 1e3))
        for k, (n, us) in sorted(norms.items(), key=lambda kv: -kv[1][1]):
            print('    {0} launches, {1:.3f} ms: {2}'.format(n, us / 1e3,
                                                           k[:160]))
        del step
        torch.cuda.empty_cache()
    return out


TRAIN_CFG = """
[dataset]
task_type = seg
root_dir = {root}
modal_num = 1
1_train_csv = {root}/d0_train.csv
2_train_csv = {root}/{d1_train}
1_valid_csv = {root}/d0_valid.csv
2_valid_csv = {root}/d1_valid.csv
test_csv = {root}/target_test.csv
train_batch_size = {batch}
num_workder = {workers}
train_transform = {train_chain}
valid_transform = [NormalizeWithMeanStd, Pad, LabelToProbability]
test_transform = [NormalizeWithMeanStd, Pad]
NormalizeWithMeanStd_channels = [0]
Pad_output_size = [28, 128, 128]
RandomCrop_output_size = [28, 128, 128]
RandomCrop_foreground_focus = True
RandomCrop_foreground_ratio = 0.5
RandomCrop_mask_label = [1]
RandomFlip_flip_depth = False
RandomFlip_flip_height = True
RandomFlip_flip_width = True

[network]
net_type = UNet2D5_dsbn
num_domains = 2
class_num = 2
in_chns = 1
feature_chns = [32, 64, 128, 256, 512]
conv_dims = [2, 2, 3, 3, 3]
dropout = [0.0, 0.0, 0.3, 0.4, 0.5]
bilinear = False

[training]
dual = {dual}
train_fpl_uda = {fpl_uda}
val_t2 = True
loss_type = DiceLoss
optimizer = Adam
learning_rate = 1e-4
momentum = 0.9
weight_decay = 1e-5
lr_scheduler = MultiStepLR
lr_gamma = 0.5
lr_milestones = [5]
iter_start = {iter_start}
iter_max = {iter_max}
iter_valid = 2
iter_save = 2
precision = {precision}
ckpt_save_dir = {root}/model/{ckpt}
{extra}

[testing]
ckpt_mode = 0
domian_label = 1
output_dir = {root}/out_train_{tag}
sliding_window_enable = True
sliding_window_size = [28, 128, 128]
sliding_window_stride = [28, 128, 128]
tta_mode = 1
patch_chunk = 2
{evaluation}
"""
TRAIN_CHAIN = ('[NormalizeWithMeanStd, Pad, RandomCrop, RandomFlip, '
               'LabelToProbability]')
EVAL_SECTION = """
[evaluation]
metric_1 = dice
metric_2 = assd
label_list = [1]
organ_name = block
ground_truth_folder_root = {root}
test_evaluation_image_pair = {root}/test_pairs.csv
"""


def train_cfg(root, tag, d1_train='d1_train.csv', fpl_uda=False, start=0,
              stop=2, precision='float32', ckpt='train', batch=TRAIN_BATCH,
              chain=TRAIN_CHAIN, dual=True, extra='', evaluation='',
              workers=0):
    """A train cfg; ``workers`` is its ``num_workder``, 0 (the items made
    in the main process) unless a phase asks for the pool."""
    cfg = os.path.join(root, 'train_{0}.cfg'.format(tag))
    with open(cfg, 'w') as f:
        f.write(TRAIN_CFG.format(
            root=root, d1_train=d1_train, fpl_uda=fpl_uda, iter_start=start,
            iter_max=stop, precision=precision, tag=tag, ckpt=ckpt,
            batch=batch, train_chain=chain, dual=dual, extra=extra,
            evaluation=evaluation, workers=workers))
    return cfg


def write_train_workspace(root, names, rel_csv):
    """Labels for the phase-4 volumes (domain 1), two more labelled volumes
    of other contrast (domain 0), the manifests, and phase 9's weighted
    CSV rewritten relative to ``root``."""
    from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_nifti
    geom = ImageGeometry(origin=(0., 0., 0.), spacing=(0.4, 0.4, 1.5),
                         direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
    rs = np.random.RandomState(SEED + 8)
    lab = np.zeros(VOLUME, np.int16)
    lab[12:28, 60:100, 100:170] = 1      # the bright block of phase 4
    os.makedirs(os.path.join(root, 'lab'))
    os.makedirs(os.path.join(root, 'src'))
    rows = {0: [], 1: []}
    for name in names:
        lab_name = 'lab/' + os.path.basename(name)
        write_nifti(NiftiImage(lab, geom), os.path.join(root, lab_name))
        rows[1].append((name, lab_name))
    for case in range(2):
        vol = rs.normal(60.0, 15.0, size=VOLUME).astype(np.float32)
        vol[lab > 0] += 50.0
        name = 'src/case{0}.nii.gz'.format(case)
        write_nifti(NiftiImage(vol, geom), os.path.join(root, name))
        rows[0].append((name, 'lab/' + os.path.basename(names[0])))
    for d in (0, 1):
        for split in ('train', 'valid'):
            with open(os.path.join(root, 'd{0}_{1}.csv'.format(d, split)),
                      'w') as f:
                f.write('image,label\n' + ''.join(
                    '{0},{1}\n'.format(*r) for r in rows[d]))
    # the dual-consistency variant's target manifest: a domain-0 volume
    # stands in for each volume's fake-source translation (image1)
    with open(os.path.join(root, 'd1_train_image1.csv'), 'w') as f:
        f.write('image,label,image1\n' + ''.join(
            '{0},{1},{2}\n'.format(a, b, rows[0][i % 2][0])
            for i, (a, b) in enumerate(rows[1])))
    # the evaluation's (ground truth, auto-test label) pairs
    with open(os.path.join(root, 'test_pairs.csv'), 'w') as f:
        f.write('ground_truth,segmentation\n' + ''.join(
            '{0},{1}\n'.format(b, os.path.basename(a)) for a, b in rows[1]))
    with open(os.path.join(root, 'train_weighted.csv'), newline='') as f:
        weighted = list(csv.reader(f))
    with open(os.path.join(root, rel_csv), 'w') as f:
        f.write(','.join(weighted[0]) + '\n')
        for row in weighted[1:]:
            f.write(','.join([os.path.relpath(p, root) for p in row[:3]]
                             + row[3:]) + '\n')


def train_cli_phase(root, names, fwd_per_volume):
    """The generator run with its auto test stage, then the resumed
    weighted run, through ``fpl_plus_torch.cli main(['train', cfg])``."""
    from fpl_plus_torch import cli
    from fpl_plus_torch.agents.agent_seg import SegmentationAgent
    from fpl_plus_torch.engine.train import JointTrainStep
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    write_train_workspace(root, names, 'train_weighted_rel.csv')
    valid_volumes = 2 + N_VOLUMES        # domain 0 and domain 1
    ckpt_dir = os.path.join(root, 'model', 'train')
    runs = {}
    for tag, d1_train, fpl_uda, start, stop, precision in (
            ('gen', 'd1_train.csv', False, 0, 4, 'float32'),
            ('seg', 'train_weighted_rel.csv', True, 4, 6, 'bfloat16')):
        # the generator run evaluates its auto-test labels (eva_main)
        cfg = train_cfg(root, tag, d1_train, fpl_uda, start, stop, precision,
                        evaluation=EVAL_SECTION.format(root=root)
                        if tag == 'gen' else '')
        step_ms, valid_ms, eval_s = [], [], []
        with timed_method(JointTrainStep, '__call__', step_ms), \
                timed_method(SegmentationAgent, 'validation', valid_ms), \
                timed_function(cli, 'eva_main', eval_s), \
                counting_forwards() as forwards:
            dsbn_prelu.launches = 0      # the main path's count starts here
            rc = cli.main(['train', cfg])
            launches = dsbn_prelu.launches
        check(rc == 0, 'train stage {0} rc {1}'.format(tag, rc))
        # a validation every 2 iterations; the auto test: N_VOLUMES
        n_eval = valid_volumes * (stop - start) // 2 + N_VOLUMES
        check(forwards[0] == n_eval * fwd_per_volume,
              '{0} eval forwards in the {1} run, expected {2}'.format(
                  forwards[0], tag, n_eval * fwd_per_volume))
        check(launches == 18 * forwards[0],
              '{0} kernel launches for {1} eval forwards'.format(
                  launches, forwards[0]))
        check(len(step_ms) == stop - start, '{0} train steps'.format(
            len(step_ms)))
        with open(os.path.join(ckpt_dir, 'scalars.jsonl')) as f:
            recs = [json.loads(line) for line in f]
        recs = [r for r in recs if start < r['step'] <= stop]
        losses = [r[k] for r in recs if r['tag'] == 'loss'
                  for k in ('train', 'valid')]
        wait = [r['value'] for r in recs if r['tag'] == 'host_wait']
        check(len(losses) == stop - start and all(np.isfinite(losses)),
              'losses {0}'.format(losses))
        for it in range(start + 2, stop + 1, 2):
            check(os.path.isfile(os.path.join(ckpt_dir, 'train_{0}.pt'
                                              .format(it))),
                  'checkpoint of iteration {0}'.format(it))
        with open(os.path.join(ckpt_dir, 'train_latest.txt')) as f:
            check(f.read() == str(stop), 'latest pointer')
        check(os.path.isfile(os.path.join(ckpt_dir, 'train_best.txt')),
              'best pointer')
        saved = torch.load(os.path.join(ckpt_dir, 'train_{0}.pt'.format(
            stop)), map_location='cpu', weights_only=False)
        opt = saved['optimizer_state_dict']
        adam_steps = {int(v['step']) for v in opt['state'].values()}
        check(opt['param_groups'][0]['update_count'] == stop
              and adam_steps == {stop},
              'optimizer step count {0} / {1} after iteration {2}'.format(
                  opt['param_groups'][0]['update_count'], adam_steps, stop))
        labels = [n for n in os.listdir(os.path.join(
            root, 'out_train_' + tag, 'train_target_test'))
            if n.endswith('.nii.gz')]
        check(len(labels) == N_VOLUMES, 'auto test labels {0}'.format(
            labels))
        check(len(eval_s) == (tag == 'gen'), 'eva_main calls {0}'.format(
            len(eval_s)))
        runs[tag] = {'launches': launches, 'forwards': forwards[0],
                     'step_ms': step_ms, 'eval_s': eval_s,
                     'valid_ms': [t / valid_volumes for t in valid_ms],
                     'host_wait_s': wait, 'losses': losses}
        print('train {0}: iterations {1}..{2} ({3}), {4} steps at {5} ms '
              '(CUDA events around the step call, the first with warm-up), '
              'host wait per iteration {6} s, validation {7} ms ({8} '
              'volumes each), {9} eval forwards, {10} kernel launches, '
              'losses {11}, optimizer step count {12}'.format(
                  tag, start, stop, precision,
                  len(step_ms), ['{0:.1f}'.format(t) for t in step_ms],
                  ['{0:.4f}'.format(w) for w in wait],
                  ['{0:.1f}'.format(t) for t in valid_ms], valid_volumes,
                  forwards[0], launches,
                  ['{0:.4f}'.format(v) for v in losses], stop))
    return runs


EVAL_ONLY_CFG = """
[evaluation]
metric_1 = dice
metric_2 = assd
label_list = [1]
organ_name = block
ground_truth_folder_root = {root}
segmentation_folder_root = {seg}
test_evaluation_image_pair = {root}/test_pairs.csv
"""


def read_csv(path):
    with open(path, newline='') as f:
        return list(csv.reader(f))


def evaluation_phase(root, train):
    """(14) The CSVs ``eva_main`` wrote after phase 13's auto test, the same
    reports from ``python -m fpl_plus_torch.metrics`` alone, the C++
    distance against its plain version on a crop, and its time on one
    full edge map."""
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    from fpl_plus_torch.metrics.seg_metrics import get_edge_points
    from fpl_plus_torch.native import (raster_scan_distance,
                                       raster_scan_reference)
    seg = os.path.join(root, 'out_train_gen', 'train_target_test')
    outs = ['test_block_{0}_all.csv'.format(m) for m in ('dice', 'assd')]
    in_train = {}
    for name in outs:
        rows = read_csv(os.path.join(seg, name))
        values = [float(r[1]) for r in rows[1:]]
        check(rows[0] == ['image', 'class_1'] and len(rows) == N_VOLUMES + 3
              and all(np.isfinite(values)), '{0}: {1}'.format(name, rows))
        in_train[name] = rows
    cfg = os.path.join(root, 'eval_only.cfg')
    with open(cfg, 'w') as f:
        f.write(EVAL_ONLY_CFG.format(root=root, seg=seg))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, '-m', 'fpl_plus_torch.metrics', cfg],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    standalone_s = time.perf_counter() - t0
    check(r.returncode == 0, 'python -m fpl_plus_torch.metrics: {0}'.format(
        r.stderr[-2000:]))
    for name in outs:
        check(read_csv(os.path.join(seg, name)) == in_train[name],
              'standalone {0} differs from the in-train one'.format(name))
    per_volume = float(np.sum(train['gen']['eval_s'])) / N_VOLUMES
    lab = load_image_as_nd_array(os.path.join(root, 'lab', 'case0.nii.gz'))[
        'data_array'][0] > 0
    edge = get_edge_points(lab)
    spacing = load_image_as_nd_array(os.path.join(
        root, 'lab', 'case0.nii.gz'))['spacing']
    crop = edge[10:16, 52:76, 92:116]
    got = raster_scan_distance(crop, spacing)
    want = raster_scan_reference(crop, spacing)
    err = float(np.max(np.abs(got - want) / np.maximum(want, 1e-6)))
    check(err <= 1e-5 and crop.any(), 'C++ distance vs plain rel err '
          '{0}'.format(err))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        full = raster_scan_distance(edge, spacing)
        times.append(time.perf_counter() - t0)
    check(bool(np.isfinite(full).all()), 'distance map not finite')
    print('evaluation: eva_main after the auto test {0:.3f} s per volume '
          '(dice + assd, {1} volumes; host); {2}; python -m '
          'fpl_plus_torch.metrics alone {3:.2f} s, same CSVs; C++ distance '
          'vs plain on a {4} crop: max rel err {5:.3g}; C++ distance on one '
          '{6} edge map median {7:.3f} s (host)'.format(
              per_volume, N_VOLUMES, {n: in_train[n][-2][1] for n in outs},
              standalone_s, list(crop.shape), err, list(edge.shape),
              float(np.median(times))))
    return {'s_per_volume': per_volume, 'distance_s': float(np.median(times)),
            'distance_err': err, 'standalone_s': standalone_s}


def variants_phase(root, fwd_per_volume):
    """(15) The training variants through ``cli train``, 2 iterations each
    at f32: alternating, accumulation (2 + 2 crops per microbatch), the
    discriminator and dual consistency (``image1``, gate from it 0)."""
    from fpl_plus_torch import cli
    from fpl_plus_torch.engine.train import (AlternatingTrainStep,
                                             DiscriminatorStep,
                                             DualConsistencyStep,
                                             JointTrainStep)
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    dual = ('[NormalizeWithMeanStd_dual, Pad_dual, RandomCrop, RandomFlip, '
            'LabelToProbability]')
    # tag: (step classes timed, dual, extra [training] keys, batch, updates
    #       per iteration, eval forwards per iteration inside the step,
    #       domain-1 manifest, train chain)
    variants = {
        'alt': ((AlternatingTrainStep,), False, '', TRAIN_BATCH, 2, 0,
                'd1_train.csv', TRAIN_CHAIN),
        'accum': ((JointTrainStep,), True, 'grad_accum_steps = 2', 2, 1, 0,
                  'd1_train.csv', TRAIN_CHAIN),
        'dis': ((JointTrainStep, DiscriminatorStep), True, 'dis = True',
                TRAIN_BATCH, 1, 2, 'd1_train.csv', TRAIN_CHAIN),
        'consis': ((DualConsistencyStep,), True,
                   'dual_consistency = True\nconsistency_start = 0',
                   TRAIN_BATCH, 2, 1, 'd1_train_image1.csv', dual),
    }
    valid_volumes = 2 + N_VOLUMES
    results = {}
    for tag, (classes, dual_step, extra, batch, upi, step_evals, d1_train,
              chain) in variants.items():
        ckpt = 'var_' + tag
        cfg = train_cfg(root, tag, d1_train, ckpt=ckpt, batch=batch,
                        chain=chain, dual=dual_step, extra=extra)
        sinks = {c.__name__: [] for c in classes}
        with contextlib.ExitStack() as stack:
            for c in classes:
                stack.enter_context(timed_method(c, '__call__',
                                                 sinks[c.__name__]))
            forwards = stack.enter_context(counting_forwards())
            torch.cuda.reset_peak_memory_stats()
            dsbn_prelu.launches = 0      # the main path's count starts here
            rc = cli.main(['train', cfg])
            launches = dsbn_prelu.launches
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(rc == 0, 'variant {0} rc {1}'.format(tag, rc))
        n_eval = (valid_volumes + N_VOLUMES) * fwd_per_volume + 2 * step_evals
        check(forwards[0] == n_eval, '{0}: {1} eval forwards, expected {2}'
              .format(tag, forwards[0], n_eval))
        check(launches == 18 * forwards[0], '{0}: {1} launches for {2} eval '
              'forwards'.format(tag, launches, forwards[0]))
        ckpt_dir = os.path.join(root, 'model', ckpt)
        saved = torch.load(os.path.join(ckpt_dir, ckpt + '_2.pt'),
                           map_location='cpu', weights_only=False)
        opt = saved['optimizer_state_dict']
        steps = {int(v['step']) for v in opt['state'].values()}
        check(opt['param_groups'][0]['update_count'] == 2 * upi
              and steps == {2 * upi}, '{0}: update count {1} / {2}'.format(
                  tag, opt['param_groups'][0]['update_count'], steps))
        if tag == 'dis':
            check('dis_state_dict' in saved
                  and 'dis_optimizer_state_dict' in saved,
                  'no discriminator state in the checkpoint')
        recs = [json.loads(line) for line in open(os.path.join(
            ckpt_dir, 'scalars.jsonl'))]
        scalars = {r['tag']: r for r in recs}
        losses = [scalars['loss']['train'], scalars['loss']['valid']]
        for key in {'dis': ['loss_dis'], 'consis': ['loss_consis']}.get(
                tag, []):
            losses.append(scalars[key]['train'])
        check(all(np.isfinite(losses)), '{0} losses {1}'.format(tag, losses))
        step_ms = [sum(ms) for ms in zip(*sinks.values())]
        check(len(step_ms) == 2, '{0}: {1} steps'.format(tag, len(step_ms)))
        results[tag] = {'launches': launches, 'forwards': forwards[0],
                        'step_ms': step_ms, 'peak_gib': peak,
                        'losses': losses, 'updates': 2 * upi}
        print('variant {0} (dual = {1}): 2 iterations, step ms {2} (CUDA '
              'events, the first with warm-up{3}), peak device memory '
              '{4:.2f} GiB, '
              '{5} updates, losses {6}, {7} eval forwards ({8} in the '
              'steps), {9} kernel launches'.format(
                  tag, '{0}{1}'.format(dual_step, ', ' + extra.replace(
                      '\n', ', ') if extra else ''),
                  ['{0:.1f}'.format(t) for t in step_ms],
                  '; segmenter + discriminator step' if tag == 'dis' else '',
                  peak, 2 * upi, ['{0:.4f}'.format(v) for v in losses],
                  forwards[0], 2 * step_evals, launches))
    return results


def make_variant_step(kind, net):
    """The alternating or dual-consistency step with plain SGD: Adam would
    turn the rounding-noise gradients of the convolution biases in front of
    a DSBN (zero in exact arithmetic) into +-rate moves of their own sign
    on each side, which the second update's forward then reads."""
    from fpl_plus_torch.engine.optim import create_optimizer
    from fpl_plus_torch.engine.train import (AlternatingTrainStep,
                                             DualConsistencyStep)
    from fpl_plus_torch.losses import create_loss_calculator
    cfg = {'optimizer': 'SGD', 'learning_rate': 1e-4, 'weight_decay': 0.0,
           'loss_type': 'DiceLoss'}
    args = (net.train(), create_loss_calculator({'training': cfg}),
            create_optimizer(cfg, net.parameters()))
    if kind == 'alternating':
        return AlternatingTrainStep(*args, num_domains=2, fpl_uda=True,
                                    entropy_coeff=1.0)
    return DualConsistencyStep(*args, fpl_uda=True)


def variant_check_phase(dev):
    """(16) One alternating and one dual-consistency step (gate 1) of the
    full-width network with SGD, card vs CPU (TF32 off, dropout 0, 1 + 1
    crops): loss, class dice, the second update's gradients and the DSBN
    running statistics, by phase 11's tolerances."""
    from fpl_plus_torch.models.registry import create_network
    net = create_network(dict(NET_CFG, dropout=[0.0] * 5))
    init_random_(net, SEED + 9)
    # logits of order 1 (He-initialised random weights give ~100), so that
    # the consistency MSE is of the order of the Dice loss and phase 11's
    # absolute loss tolerance means the same for both steps
    with torch.no_grad():
        net.out_conv.weight.mul_(0.02)
    gen = torch.Generator().manual_seed(SEED + 10)
    batches = [train_inputs(gen, 1, 'cpu') for _ in range(2)]
    batches[1]['image1'] = batches[1]['image'] * 0.7 + 0.3 * torch.randn(
        batches[1]['image'].shape, generator=gen)
    out = {}
    for kind in ('alternating', 'consistency'):
        net_dev = copy.deepcopy(net).to(dev)
        net_cpu = copy.deepcopy(net)
        args = ([None] * 3, 1.0) if kind == 'consistency' else ([None] * 2,)
        with tf32_off():
            got = make_variant_step(kind, net_dev)(
                [{k: v.to(dev) for k, v in b.items()} for b in batches],
                *args)
            torch.cuda.synchronize()
        want = make_variant_step(kind, net_cpu)(batches, *args)
        loss_err = abs(float(got['loss']) - float(want['loss']))
        dice_err = max(float((got[k].cpu() - want[k]).abs().max())
                       for k in ('class_dice_0', 'class_dice_1'))
        grads = {k: p.grad for k, p in net_cpu.named_parameters()}
        top = max(float(g.abs().max()) for g in grads.values())
        worst, worst_name = 0.0, None
        for name, p in net_dev.named_parameters():
            err = float((p.grad.cpu() - grads[name]).abs().max())
            ratio = err / (GRAD_RTOL * float(grads[name].abs().max())
                           + GRAD_NET_TOL * top)
            if ratio > worst:
                worst, worst_name = ratio, name
        cpu_sd = net_cpu.state_dict()
        stats_err = max(
            float((t.cpu() - cpu_sd[n]).abs().max() / cpu_sd[n].abs().max())
            for n, t in net_dev.state_dict().items()
            if n.endswith(('running_mean', 'running_var')))
        consis = ''
        if kind == 'consistency':
            consis = '; loss_consis {0!r} vs {1!r}'.format(
                float(got['loss_consis']), float(want['loss_consis']))
        print('variant step {0} card vs CPU (full width, 1+1 crops, SGD, '
              'TF32 off): loss {1!r} vs {2!r} (abs err {3:.3g}, tolerance '
              '{4}); class dice max abs err {5:.3g}; the second update\'s '
              'gradients: worst tensor {6} at {7:.3g} of its tolerance; DSBN '
              'running statistics max rel err {8:.3g} (tolerance {9}){10}'
              .format(kind, float(got['loss']), float(want['loss']),
                      loss_err, STEP_LOSS_TOL, dice_err, worst_name, worst,
                      stats_err, STATS_TOL, consis))
        check(loss_err <= STEP_LOSS_TOL, kind + ' step loss disagrees')
        check(dice_err <= STEP_DICE_TOL, kind + ' step dice disagrees')
        check(worst <= 1.0, '{0} step gradient {1} disagrees'.format(
            kind, worst_name))
        check(stats_err <= STATS_TOL, kind + ' DSBN statistics disagree')
        out[kind] = {'loss_err': loss_err, 'grad_worst': worst,
                     'stats_err': stats_err}
        del net_dev
        torch.cuda.empty_cache()
    return out


def test_paths_phase(root, names, serving, fpl):
    """(17) The test stage's other paths through the CLI on the phase-4
    volumes: the host path (``infer_device_label = False``) against the
    device-label labels, the FPL host fallback against phase 7, checkpoint
    ensembles of phase 13's checkpoints, and a CenterCrop chain."""
    from fpl_plus_torch import cli
    from fpl_plus_torch.engine.infer import Inferer, window_grid
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    ckpt_dir = os.path.join(root, 'model', 'train')
    train2, train4 = (os.path.join(ckpt_dir, 'train_{0}.pt'.format(i))
                      for i in (2, 4))
    crop_fwd = -(-len(window_grid(CROP_VOLUME, WINDOW, WINDOW))
                 // PATCH_CHUNK)
    fwd = -(-len(window_grid(VOLUME, WINDOW, WINDOW)) // PATCH_CHUNK)
    host = 'infer_device_label = False'
    npy = os.path.join(root, 'fpl_host.npy')
    runs = (
        ('host', 'run_async', host, 0, '', None, fwd),
        ('fpl_host', 'run_passes_async', host + '\nfpl = True\n'
         'fpl_uncertainty_sorted = ' + npy, 0, '', None, fwd),
        ('ens', 'run_logits', '', 3, [train2, train4], None, 2 * fwd),
        ('ens_aa', 'run_logits', '', 3, [train4, train4], None, 2 * fwd),
        ('single', 'run_async', host, 2, train4, None, fwd),
        ('crop', 'run_async', '', 0, '', '[NormalizeWithMeanStd, CenterCrop]',
         crop_fwd),
    )
    results = {}
    for tag, method, extra, mode, ckpt_name, chain, fwd_v in runs:
        if ckpt_name:
            extra += '\nckpt_name = ' + (
                '[{0}]'.format(', '.join(ckpt_name))
                if isinstance(ckpt_name, list) else ckpt_name)
        cfg = write_cfg(root, tag, extra=extra, mode=mode,
                        chain=chain or '[NormalizeWithMeanStd, Pad]')
        ms = []
        with timed_dispatch(Inferer, method, ms), \
                counting_forwards() as forwards:
            dsbn_prelu.launches = 0      # the main path's count starts here
            rc = cli.main(['test', cfg])
            launches = dsbn_prelu.launches
        check(rc == 0, '{0} stage rc {1}'.format(tag, rc))
        check(forwards[0] == N_VOLUMES * fwd_v, '{0}: {1} forwards, expected '
              '{2}'.format(tag, forwards[0], N_VOLUMES * fwd_v))
        check(launches == 18 * forwards[0], '{0}: {1} launches for {2} '
              'forwards'.format(tag, launches, forwards[0]))
        labels = None
        if tag != 'fpl_host':
            labels = [load_image_as_nd_array(os.path.join(
                root, 'out_' + tag, 'gen_target_test', os.path.basename(n)))[
                'data_array'] for n in names]
            for lab in labels:
                check(lab.shape == (1,) + VOLUME, '{0} label shape {1}'.format(
                    tag, lab.shape))
        per_volume = sum(ms) / N_VOLUMES
        results[tag] = {'launches': launches, 'forwards': forwards[0],
                        'ms': per_volume, 'labels': labels}
        print('test path {0}: {1} forwards, {2} kernel launches, Inferer.{3} '
              '{4:.2f} ms per volume (CUDA events)'.format(
                  tag, forwards[0], launches, method, per_volume))

    agree = [float(np.mean(a == b)) for a, b in zip(
        results['host']['labels'], serving['float32']['labels'])]
    check(min(agree) >= BATCH_AGREE, 'host path labels agree with the '
          'device-label path on {0}'.format(agree))
    entries = np.load(npy, allow_pickle=True)
    host_u = {str(e[1]): float(np.asarray(e[0]).reshape(-1)[0])
              for e in entries}
    dev_u = fpl['float32']['by_name']
    rel = max(abs(host_u[n] - dev_u[n]) / abs(dev_u[n]) for n in dev_u)
    check(sorted(host_u) == sorted(dev_u) and rel <= REDUCE_RTOL,
          'FPL host fallback {0} vs device {1}'.format(host_u, dev_u))
    same = [bool(np.array_equal(a, b)) for a, b in zip(
        results['ens_aa']['labels'], results['single']['labels'])]
    check(all(same), 'an ensemble of one checkpoint twice differs from it')
    crop_lab = results['crop']['labels']
    lo = [(v - c) // 2 for v, c in zip(VOLUME, CROP_VOLUME)]
    outside = sum(int(lab[0, :, :lo[1]].sum() + lab[0, :, :, :lo[2]].sum())
                  for lab in crop_lab)
    check(outside == 0, 'CenterCrop inverse: {0} labels outside the '
          'crop'.format(outside))
    print('test paths: host-path labels agree with the device-label path on '
          '{0}; FPL host fallback vs device uncertainties max rel err {1:.3g} '
          '(tolerance {2}); ensemble [A, A] labels equal the single '
          'checkpoint\'s: {3}; ensemble [train_2, train_4] foreground share '
          '{4:.4f}'.format(agree, rel, REDUCE_RTOL, all(same), float(np.mean(
              [lab.mean() for lab in results['ens']['labels']]))))
    for r in results.values():
        r.pop('labels')
    results['host_agree'] = agree
    results['fpl_host_rel_err'] = rel
    return results



# phases 18-20: the network zoo at the FPL+ widths (bench.py:60 NET_CFG)
ZOO_CFG = {'in_chns': 1, 'class_num': 2,
           'feature_chns': [32, 64, 128, 256, 512],
           'dropout': [0.0, 0.0, 0.3, 0.4, 0.5]}
ZOO_SMALL = [8, 16, 16, 32, 32]           # the card-vs-CPU check's widths
ZOO_WINDOW_3D = [32, 128, 128]            # every axis divides by 16
ZOO_REPS = 5
# tag: (net_type, extra [network] keys); phase 19 trains all but the plain
# UNet2D and UNet3D (their deep-supervised versions stand for them)
ZOO = {
    'UNet2D': ('UNet2D', {}),
    'UNet2D-ds': ('UNet2D', {'deep_supervise': True}),
    'UNet2D_ScSE': ('UNet2D_ScSE', {}),
    'UNet2D_DualBranch': ('UNet2D_DualBranch', {}),
    'UNet2D_URPC': ('UNet2D_URPC', {}),
    'UNet2D_CCT': ('UNet2D_CCT', {}),
    'AttentionUNet2D': ('AttentionUNet2D', {}),
    'NestedUNet2D': ('NestedUNet2D', {}),
    'COPLENet': ('COPLENet', {}),
    'UNet3D': ('UNet3D', {}),
    'UNet3D-ds': ('UNet3D', {'deep_supervise': True}),
    'UNet3D_ScSE': ('UNet3D_ScSE', {}),
    'AEs': ('AEs', {}),
}
ZOO_TRAIN = [t for t in ZOO if t not in ('UNet2D', 'UNet3D')]
# heads of a forward: eval mode / train mode (a list, or 1 for a tensor)
ZOO_HEADS = {'UNet2D-ds': (4, 4), 'UNet3D-ds': (4, 4),
             'UNet2D_URPC': (4, 4), 'UNet2D_DualBranch': (1, 2),
             'UNet2D_CCT': (1, 4)}


def as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def zoo_net(tag, seed, widths=None):
    from fpl_plus_torch.models.registry import NETS_3D, create_network
    net_type, extra = ZOO[tag]
    cfg = dict(ZOO_CFG, net_type=net_type, **extra)
    if widths is not None:
        cfg['feature_chns'] = widths
    net = create_network(cfg)
    init_random_(net, seed)
    window = ZOO_WINDOW_3D if net_type in NETS_3D else WINDOW
    return net, cfg, list(window)


def heads_agree(got, want):
    """Max abs err over the heads and the tolerance of phase 3."""
    err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return err, FWD_TOL * max(1.0, scale)


def zoo_phase(dev):
    """(18) Each network of the zoo: card vs CPU at small width (TF32 off,
    one state dict), then one eval forward of BATCH windows at full width
    (2D nets: [28,128,128] windows folded to 8 x 28 slices; 3D nets:
    [32,128,128]), timed by CUDA events (median of ZOO_REPS after a
    warm-up that counts the MACs), with its peak device memory. None may
    launch the DSBN+PReLU kernel."""
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    before = dsbn_prelu.launches
    results = {}
    for i, tag in enumerate(ZOO):
        small, _, window = zoo_net(tag, SEED + 20 + i, ZOO_SMALL)
        small.eval()
        gen = torch.Generator().manual_seed(SEED + 40 + i)
        xs = torch.randn((2, 1, window[0] // 2, 64, 64), generator=gen)
        with tf32_off(), torch.inference_mode():
            want = as_list(small(xs))
            got = as_list(copy.deepcopy(small).to(dev)(xs.to(dev)))
        err, tol = heads_agree(got, want)
        check(err <= tol, '{0} card vs CPU max abs err {1} > {2}'.format(
            tag, err, tol))
        net, _, window = zoo_net(tag, SEED + 60 + i)
        net = net.to(dev).eval()
        x = torch.randn((BATCH, 1) + tuple(window), generator=gen).to(dev)
        with torch.inference_mode():
            with counting_macs(net) as macs:
                out = as_list(net(x))
            torch.cuda.synchronize()
            check(len(out) == ZOO_HEADS.get(tag, (1, 1))[0]
                  and all(bool(torch.isfinite(o).all()) for o in out)
                  and out[0].shape[2:] == x.shape[2:],
                  '{0} outputs {1}'.format(tag, [o.shape for o in out]))
            del out
            torch.cuda.reset_peak_memory_stats(dev)
            ms = []
            for _ in range(ZOO_REPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                net(x)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        gmac = macs[0] / BATCH / 1e9
        med = float(np.median(ms))
        results[tag] = {'gmac_per_window': gmac, 'ms': med, 'ms_all': ms,
                        'peak_gib': peak, 'small_err': err,
                        'small_tol': tol}
        print('zoo {0}: card vs CPU at widths {1} max abs err {2:.3g} '
              '(tolerance {3:.3g}); full width, {4} windows of {5}: {6:.3f} '
              'GMAC per window, eval forward median {7:.2f} ms (min {8:.2f}, '
              'max {9:.2f}), {10:.1f} TFLOP/s, peak {11:.2f} GiB'.format(
                  tag, ZOO_SMALL, err, tol, BATCH, window, gmac, med,
                  min(ms), max(ms), 2 * macs[0] / med / 1e9, peak))
        del net, x, small
        torch.cuda.empty_cache()
    check(dsbn_prelu.launches == before, 'the zoo launched the DSBN+PReLU '
          'kernel {0} times'.format(dsbn_prelu.launches - before))
    return results


def zoo_train_phase(dev, zoo):
    """(19) One single-domain training run of 3 steps per zoo net (the
    CLI's default step: alternating with the entropy term), batch 4 crops
    of its window, Adam, the network's dropout from a card generator: the
    median CUDA-event ms of steps 2-3 and the peak device memory. The
    deep-supervised nets run DeepSuperviseLoss over DiceLoss; DualBranch,
    CCT and URPC hand the loss their train-mode lists; AEs learns to
    reconstruct its input (MSE, no softmax, no entropy term)."""
    from fpl_plus_torch.engine.optim import create_optimizer
    from fpl_plus_torch.engine.train import AlternatingTrainStep
    from fpl_plus_torch.losses import create_loss_calculator
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    before = dsbn_prelu.launches
    results = {}
    for i, tag in enumerate(ZOO_TRAIN):
        net, cfg, window = zoo_net(tag, SEED + 80 + i)
        net = net.to(dev).train()
        gen = torch.Generator().manual_seed(SEED + 100 + i)
        x = torch.randn((TRAIN_BATCH, 1) + tuple(window), generator=gen)
        aes = tag == 'AEs'
        if aes:
            train_cfg = {'loss_type': 'MSELoss', 'loss_softmax': False}
            label = x
        else:
            train_cfg = {'loss_type': 'DiceLoss'}
            label = F.one_hot((x[:, 0] > 0.5).long(), 2).movedim(-1, 1)
        batch = {'image': x.to(dev), 'label_prob': label.float().to(dev)}
        opt_cfg = {'optimizer': 'Adam', 'learning_rate': 1e-4,
                   'weight_decay': 0.0}
        step = AlternatingTrainStep(
            net, create_loss_calculator({'training': train_cfg,
                                         'network': cfg}),
            create_optimizer(opt_cfg, net.parameters()), num_domains=1,
            entropy_coeff=0.0 if aes else 1.0)
        heads = []
        hook = net.register_forward_hook(
            lambda m, a, o: heads.append(len(as_list(o))))
        torch.cuda.reset_peak_memory_stats(dev)
        ms, losses = [], []
        for k in range(3):
            gens = [[torch.Generator(dev).manual_seed(SEED + 7 * k + i)]]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step([batch], gens)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(m['loss']))
        hook.remove()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        check(all(np.isfinite(losses)), '{0} losses {1}'.format(tag, losses))
        check(heads == [ZOO_HEADS.get(tag, (1, 1))[1]] * 3,
              '{0} train-mode heads {1}'.format(tag, heads))
        med = float(np.median(ms[1:]))
        tflop = 3 * 2 * zoo[tag]['gmac_per_window'] * TRAIN_BATCH / 1e3
        results[tag] = {'ms': med, 'ms_all': ms, 'peak_gib': peak,
                        'tflop': tflop, 'losses': losses}
        print('zoo train {0}: batch {1} crops {2}, step {3:.2f} ms (median '
              'of steps 2-3; all {4}), {5:.3f} TFLOP per step, {6:.1f} '
              'TFLOP/s, peak {7:.2f} GiB, {8} heads to the loss, losses {9}'
              .format(tag, TRAIN_BATCH, window, med,
                      ['{0:.1f}'.format(t) for t in ms], tflop,
                      tflop / med * 1e3, peak, heads[0],
                      ['{0:.4f}'.format(v) for v in losses]))
        del step, net, batch
        torch.cuda.empty_cache()
    check(dsbn_prelu.launches == before, 'the zoo training launched the '
          'DSBN+PReLU kernel')
    return results


SUP_CFG = """
[dataset]
task_type = seg
root_dir = {root}
modal_num = 1
train_csv = {root}/d1_train.csv
valid_csv = {root}/d1_valid.csv
test_csv = {root}/target_test.csv
train_batch_size = 2
train_transform = [NormalizeWithPercentiles, RandomRescale, RandomRotate, GammaCorrection, GaussianNoise, Pad, RandomCrop, RandomFlip, LabelToProbability]
valid_transform = [NormalizeWithPercentiles, Pad, LabelToProbability]
test_transform = [NormalizeWithPercentiles, Pad]
NormalizeWithPercentiles_channels = [0]
NormalizeWithPercentiles_percentile_lower = 0.5
NormalizeWithPercentiles_percentile_upper = 99.5
RandomRescale_lower_bound = [1.0, 0.9, 0.9]
RandomRescale_upper_bound = [1.0, 1.1, 1.1]
RandomRotate_angle_range_d = [-15, 15]
RandomRotate_angle_range_h = None
RandomRotate_angle_range_w = None
GammaCorrection_channels = [0]
GammaCorrection_gamma_min = 0.8
GammaCorrection_gamma_max = 1.25
GaussianNoise_channels = [0]
GaussianNoise_mean = 0.0
GaussianNoise_std = 0.05
Pad_output_size = [28, 128, 128]
RandomCrop_output_size = [28, 128, 128]
RandomCrop_foreground_focus = True
RandomCrop_foreground_ratio = 0.5
RandomCrop_mask_label = [1]
RandomFlip_flip_depth = False
RandomFlip_flip_height = True
RandomFlip_flip_width = True

[network]
net_type = UNet2D
class_num = 2
in_chns = 1
feature_chns = [32, 64, 128, 256, 512]
dropout = [0.0, 0.0, 0.3, 0.4, 0.5]
deep_supervise = True

[training]
loss_type = DiceLoss
optimizer = Adam
learning_rate = 1e-4
momentum = 0.9
weight_decay = 1e-5
lr_scheduler = MultiStepLR
lr_gamma = 0.5
lr_milestones = [5]
iter_max = 4
iter_valid = 2
iter_save = 2
random_seed = 3
ckpt_save_dir = {root}/model/sup

[testing]
ckpt_mode = 0
output_dir = {root}/out_sup
sliding_window_enable = True
sliding_window_size = [28, 128, 128]
sliding_window_stride = [28, 128, 128]
tta_mode = 1
patch_chunk = 2
{evaluation}
"""
URPC_VOLUME = (8, 80, 88)
URPC_SW = {'sliding_window_enable': True, 'sliding_window_size': [4, 32, 32],
           'sliding_window_stride': [3, 24, 24], 'tta_mode': 1,
           'output_mode': 'logits'}


def supervised_phase(root, dev):
    """(20) ``cli train`` of a single-domain deep-supervised UNet2D at full
    width (4 iterations, validation and checkpoints every 2, the new
    transforms in its chain; the phase-13 workspace's domain-1 manifests),
    the auto test stage on the phase-4 volumes and ``eva_main``; then the
    Inferer with a UNet2D_URPC predictor (4 heads) card vs CPU at small
    width, under both ``multiscale_counter`` modes (TF32 off)."""
    from fpl_plus_torch import cli
    from fpl_plus_torch.agents.agent_seg import SegmentationAgent
    from fpl_plus_torch.engine.infer import Inferer
    from fpl_plus_torch.engine.train import AlternatingTrainStep
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    cfg = os.path.join(root, 'sup.cfg')
    with open(cfg, 'w') as f:
        f.write(SUP_CFG.format(root=root,
                               evaluation=EVAL_SECTION.format(root=root)))
    step_ms, valid_ms, eval_s = [], [], []
    with timed_method(AlternatingTrainStep, '__call__', step_ms), \
            timed_method(SegmentationAgent, 'validation', valid_ms), \
            timed_function(cli, 'eva_main', eval_s):
        dsbn_prelu.launches = 0          # this path's count starts here
        t0 = time.perf_counter()
        rc = cli.main(['train', cfg])
        wall = time.perf_counter() - t0
        launches = dsbn_prelu.launches
    check(rc == 0 and launches == 0, 'supervised run rc {0}, {1} kernel '
          'launches'.format(rc, launches))
    ckpt_dir = os.path.join(root, 'model', 'sup')
    check(len(step_ms) == 4 and all(os.path.isfile(os.path.join(
        ckpt_dir, 'sup_{0}.pt'.format(it))) for it in (2, 4)),
        'supervised steps {0} / checkpoints'.format(len(step_ms)))
    with open(os.path.join(ckpt_dir, 'scalars.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    losses = [r[k] for r in recs if r['tag'] == 'loss'
              for k in ('train', 'valid')]
    wait = [r['value'] for r in recs if r['tag'] == 'host_wait']
    check(len(losses) == 4 and all(np.isfinite(losses)),
          'supervised losses {0}'.format(losses))
    seg = os.path.join(root, 'out_sup', 'sup_target_test')
    labels = sorted(n for n in os.listdir(seg) if n.endswith('.nii.gz'))
    check(len(labels) == N_VOLUMES, 'supervised labels {0}'.format(labels))
    dice = read_csv(os.path.join(seg, 'test_block_dice_all.csv'))
    check(len(dice) == N_VOLUMES + 3 and all(
        np.isfinite(float(r[1])) for r in dice[1:]), 'dice {0}'.format(dice))
    print('supervised cli train (UNet2D, deep supervision, full width): {0} '
          'steps at {1} ms, validation {2} ms ({3} volumes each), host wait '
          '{4} s per iteration, losses {5}, eva_main {6:.2f} s, dice {7}, '
          '{8} kernel launches, {9:.1f} s wall'.format(
              len(step_ms), ['{0:.1f}'.format(t) for t in step_ms],
              ['{0:.1f}'.format(t) for t in valid_ms], N_VOLUMES,
              ['{0:.4f}'.format(w) for w in wait],
              ['{0:.4f}'.format(v) for v in losses], sum(eval_s),
              dice[-2][1], launches, wall))

    net, _, _ = zoo_net('UNet2D_URPC', SEED + 120, ZOO_SMALL)
    net.eval()
    net_dev = copy.deepcopy(net).to(dev)
    image = np.random.RandomState(SEED).normal(
        size=(1, 1) + URPC_VOLUME).astype(np.float32)
    urpc = {}
    for mode in ('exact', 'reference'):
        conf = dict(URPC_SW, multiscale_counter=mode)
        with tf32_off():
            got = Inferer(conf, dev).run(lambda x: net_dev(x), image)
            want = Inferer(conf, 'cpu').run(lambda x: net(x), image)
        err, tol = heads_agree([torch.from_numpy(g) for g in got],
                               [torch.from_numpy(w) for w in want])
        shapes = [list(g.shape[2:]) for g in got]
        check(len(got) == 4 and err <= tol, 'URPC Inferer {0}: {1} heads, '
              'max abs err {2} > {3}'.format(mode, len(got), err, tol))
        urpc[mode] = {'err': err, 'tol': tol, 'shapes': shapes}
        print('URPC Inferer {0} counter, card vs CPU (widths {1}, volume {2}, '
              'window {3} stride {4}): heads {5}, max abs err {6:.3g} '
              '(tolerance {7:.3g})'.format(
                  mode, ZOO_SMALL, list(URPC_VOLUME),
                  URPC_SW['sliding_window_size'],
                  URPC_SW['sliding_window_stride'], shapes, err, tol))
    return {'step_ms': step_ms, 'valid_ms': valid_ms, 'eval_s': eval_s,
            'host_wait_s': wait, 'losses': losses, 'launches': launches,
            'wall_s': wall, 'urpc': urpc}


PARADIGMS = {
    'ssl': ('semi_supervised_learning', 'ssl_method',
            ('EntropyMinimization', 'MeanTeacher', 'UAMT', 'CCT', 'CPS',
             'URPC')),
    'wsl': ('weakly_supervised_learning', 'wsl_method',
            ('EntropyMinimization', 'TotalVariation', 'MumfordShah',
             'GatedCRF', 'USTM', 'DMPLS')),
}
PARADIGM_NET = dict(NET_CFG, net_type='UNet2D5', num_domains=1)
PARADIGM_ZOO = {'CCT': 'UNet2D_CCT', 'URPC': 'UNet2D_URPC'}   # SSL only
BINET = ('CPS', 'DMPLS')
PARADIGM_CROP = (16, 64, 64)              # the card-vs-CPU check's crop
PARADIGM_STEPS = 3
PARADIGM_IT = 5                           # the ramp's iteration in a check


def paradigm_config(kind, method, widths=None, dropout=None,
                    optimizer='Adam'):
    """The agent config of one SSL/WSL method: UNet2D5 at NET_CFG (one
    domain), CCT and URPC on their zoo nets at phase 18's widths."""
    section, key, _ = PARADIGMS[kind]
    zoo = PARADIGM_ZOO.get(method) if kind == 'ssl' else None
    net = dict(ZOO_CFG, net_type=zoo) if zoo else dict(PARADIGM_NET)
    if widths is not None:
        net['feature_chns'] = list(widths)
    if dropout is not None:
        net['dropout'] = [dropout] * len(net['feature_chns'])
    return {'dataset': {'task_type': 'seg'}, 'network': net,
            'training': {'loss_type': 'DiceLoss', 'optimizer': optimizer,
                         'learning_rate': 1e-4, 'weight_decay': 0.0,
                         'iter_max': 100},
            'testing': {},
            section: {key: method, 'regularize_w': 0.1, 'rampup_start': 0,
                      'rampup_end': 10}}


def paradigm_agent(kind, cfg, net, dev):
    """The method's agent with ``net`` on ``dev`` and its step object."""
    from fpl_plus_torch.agents.ssl import SSLMethodDict
    from fpl_plus_torch.agents.wsl import WSLMethodDict
    from fpl_plus_torch.engine.optim import create_optimizer
    section, key, _ = PARADIGMS[kind]
    registry = SSLMethodDict if kind == 'ssl' else WSLMethodDict
    agent = registry[cfg[section][key]](cfg, 'train', dev)
    agent.module = net.to(dev).train()
    step = agent._build_step(create_optimizer(cfg['training'],
                                              net.parameters()), None)
    return agent, step


def paradigm_net(cfg, method, seed):
    from fpl_plus_torch.models.multi_net import make_binet
    from fpl_plus_torch.models.registry import create_network
    net = (make_binet if method in BINET else create_network)(
        cfg['network'])
    init_random_(net, seed)
    return net


def paradigm_batches(kind, method, gen, n, crop, dev):
    """Seeded host data of one step, on ``dev``: SSL ``{'lab', 'unlab'}``
    (n + n crops), WSL ``(batch,)`` with 10% of the voxels scribbled
    (``pixel_weight``), USTM with its rotation 1."""
    x = torch.randn((n, 1) + tuple(crop), generator=gen)
    y = F.one_hot((x[:, 0] > 0.5).long(), 2).movedim(-1, 1).float()
    if kind == 'ssl':
        unlab = torch.randn((n, 1) + tuple(crop), generator=gen)
        return {'lab': {'image': x.to(dev), 'label_prob': y.to(dev)},
                'unlab': {'image': unlab.to(dev)}}
    pw = (torch.rand((n, 1) + tuple(crop), generator=gen) < 0.1).float()
    batch = ({'image': x.to(dev), 'label_prob': y.to(dev),
              'pixel_weight': pw.to(dev)},)
    return batch + (1,) if method == 'USTM' else batch


def paradigm_hyper(agent, method, iteration):
    hyper = agent.training_hyper(iteration)
    if method == 'DMPLS':
        hyper['beta'] = 0.3
    return hyper


@contextlib.contextmanager
def equal_draws():
    """The teacher's input noise zeroed, and the draws that UNet2D_CCT and
    UNet2D_URPC make in train mode at network dropout 0 taken from CPU
    generators seeded by the tensor's shape, so that the card and the CPU
    see the same masks, quantile and noise."""
    from fpl_plus_torch.agents import ssl, wsl
    from fpl_plus_torch.models import unet2d

    def host_uniform(shape, device):
        key = int(np.prod(shape)) % (2 ** 31) + len(shape)
        return torch.rand(tuple(shape), generator=torch.Generator()
                          .manual_seed(key)).to(device)

    def dropout(x, p, generators=None):
        if p == 0 or generators is None:
            return x
        keep = host_uniform(x.shape, x.device) < 1.0 - p
        return torch.where(keep, x / (1.0 - p),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def uniform(shape, low, high, generators, device):
        full = (shape[0] * len(generators),) + tuple(shape[1:])
        return host_uniform(full, device) * (high - low) + low

    saved = [(ssl, 'noise_like'), (wsl, 'noise_like'),
             (unet2d, 'grouped_dropout'), (unet2d, '_group_uniform')]
    saved = [(m, n, getattr(m, n)) for m, n in saved]
    zeros = (lambda gen, x: torch.zeros_like(x))
    ssl.noise_like = wsl.noise_like = zeros
    unet2d.grouped_dropout, unet2d._group_uniform = dropout, uniform
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def scale_heads_(net, factor=0.02):
    """Output convolutions x ``factor``: logits of order 1. The random
    He-initialised weights give logits of ~100, whose saturated softmax
    leaves Dice gradients that cancel to a small part of their terms: a
    CPU f32 step of the small-width UNet2D5 was then 1.36 x phase 11's
    gradient tolerance away from its float64 step on a PReLU slope, and
    0.043 x with the heads scaled (the CPU, measured)."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            scope = name.split('.')[-2]
            if name.endswith('weight') and scope.startswith(('out_conv',
                                                             'head')):
                p.mul_(factor)


def paradigm_check(kind, dev):
    """(21a / 22a) One step of each method, card vs CPU at small widths:
    SGD, TF32 off, dropout 0, equal draws, heads scaled (``scale_heads_``),
    1 + 1 crops (WSL: 1 crop) of PARADIGM_CROP. Loss components, the gradients, the BN statistics and
    the teacher after its update, by phase 11's tolerances."""
    results = {}
    with equal_draws():
        for i, method in enumerate(PARADIGMS[kind][2]):
            cfg = paradigm_config(kind, method, ZOO_SMALL, 0.0, 'SGD')
            net = paradigm_net(cfg, method, SEED + 140 + i)
            scale_heads_(net)
            gen = torch.Generator().manual_seed(SEED + 160 + i)
            host = paradigm_batches(kind, method, gen, 1, PARADIGM_CROP,
                                    'cpu')
            out = []
            for where in (dev, torch.device('cpu')):
                agent, step = paradigm_agent(kind, cfg, copy.deepcopy(net),
                                             where)
                batches = host
                if where != torch.device('cpu'):
                    batches = (
                        {k: {n: t.to(where) for n, t in v.items()}
                         for k, v in host.items()} if kind == 'ssl' else
                        ({k: t.to(where) for k, t in host[0].items()},)
                        + host[1:])
                with tf32_off():
                    m = step(batches, agent._step_generators(PARADIGM_IT),
                             **paradigm_hyper(agent, method, PARADIGM_IT))
                    torch.cuda.synchronize()
                module = agent.module
                out.append({
                    'metrics': {k: v.cpu() for k, v in m.items()},
                    'grads': {k: p.grad.cpu()
                              for k, p in module.named_parameters()},
                    'stats': {k: b.cpu() for k, b in module.named_buffers()
                              if k.endswith(('running_mean', 'running_var'))},
                    'teacher': None if agent.teacher is None else {
                        k: v.cpu() for k, v in agent.teacher.params.items()}})
            got, want = out
            loss_err = max(abs(float(got['metrics'][k] - want['metrics'][k]))
                           for k in ('loss', 'loss_sup', 'loss_reg'))
            dice_err = float((got['metrics']['class_dice_0']
                              - want['metrics']['class_dice_0']).abs().max())
            top = max(float(g.abs().max()) for g in want['grads'].values())
            worst, worst_name = 0.0, None
            for name, g in got['grads'].items():
                ref = want['grads'][name]
                ratio = float((g - ref).abs().max()) / (
                    GRAD_RTOL * float(ref.abs().max()) + GRAD_NET_TOL * top)
                if ratio > worst:
                    worst, worst_name = ratio, name

            def rel(a, b):
                return max((float((a[k] - b[k]).abs().max())
                            / max(float(b[k].abs().max()), 1e-12)
                            for k in b), default=0.0)
            stats_err = rel(got['stats'], want['stats'])
            teacher_err = (rel(got['teacher'], want['teacher'])
                           if want['teacher'] is not None else None)
            print('{0} {1} card vs CPU (widths {2}, crop {3}, SGD, TF32 '
                  'off): loss {4!r} vs {5!r}, max abs err of loss / '
                  'loss_sup / loss_reg {6:.3g} (tolerance {7}); class dice '
                  'err {8:.3g}; worst gradient {9} at {10:.3g} of its '
                  'tolerance; BN statistics max rel err {11:.3g}; teacher '
                  '{12}'.format(
                      kind, method, ZOO_SMALL, list(PARADIGM_CROP),
                      float(got['metrics']['loss']),
                      float(want['metrics']['loss']), loss_err,
                      STEP_LOSS_TOL, dice_err, worst_name, worst, stats_err,
                      'none' if teacher_err is None else
                      'max rel err {0:.3g}'.format(teacher_err)))
            check(loss_err <= STEP_LOSS_TOL, '{0} {1} loss disagrees'.format(
                kind, method))
            check(dice_err <= STEP_DICE_TOL, '{0} {1} dice disagrees'.format(
                kind, method))
            check(worst <= 1.0, '{0} {1} gradient {2} disagrees'.format(
                kind, method, worst_name))
            check(stats_err <= STATS_TOL, '{0} {1} BN statistics disagree'
                  .format(kind, method))
            check(teacher_err is None or teacher_err <= STATS_TOL,
                  '{0} {1} teacher disagrees'.format(kind, method))
            results[method] = {'loss_err': loss_err, 'grad_worst': worst,
                               'stats_err': stats_err,
                               'teacher_err': teacher_err}
    return results


def paradigm_timed(kind, dev, macs):
    """(21b / 22b) Each method for PARADIGM_STEPS steps at full width
    (2 + 2 crops of WINDOW for SSL, 2 scribbled crops for WSL), Adam, the
    network's dropout: CUDA-event ms per step (median of steps 2-3), peak
    device memory; TFLOP per step reckoned for the UNet2D5 methods from
    phase 3's MACs (student rows x 3, teacher forwards x 1). No kernel
    launch (train-mode forwards only)."""
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    before = dsbn_prelu.launches
    results = {}
    for i, method in enumerate(PARADIGMS[kind][2]):
        cfg = paradigm_config(kind, method)
        net = paradigm_net(cfg, method, SEED + 180 + i)
        agent, step = paradigm_agent(kind, cfg, net, dev)
        gen = torch.Generator().manual_seed(SEED + 200 + i)
        batches = paradigm_batches(kind, method, gen, 2, WINDOW, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ms, losses = [], []
        for k in range(PARADIGM_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step(batches, agent._step_generators(k),
                     **paradigm_hyper(agent, method, k))
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append([float(m[key]) for key in
                           ('loss', 'loss_sup', 'loss_reg')])
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        check(np.isfinite(losses).all(), '{0} {1} losses {2}'.format(
            kind, method, losses))
        med = float(np.median(ms[1:]))
        rows = 4 if kind == 'ssl' else 2           # student rows
        teacher_rows = {'MeanTeacher': 2, 'UAMT': 18, 'USTM': 18}.get(
            method, 0)
        peers = 2 if method in BINET else 1
        tflop = None
        if cfg['network']['net_type'] == 'UNet2D5':
            tflop = (2 * macs * (3 * rows * peers + teacher_rows)) / 1e12
        results[method] = {'ms': med, 'ms_all': ms, 'peak_gib': peak,
                           'tflop': tflop, 'losses': losses}
        print('{0} {1} step at full width ({2}, {3} crops {4}): {5:.2f} ms '
              '(median of steps 2-{6}; all {7}), peak {8:.2f} GiB{9}, losses '
              '(loss, sup, reg) {10}'.format(
                  kind, method, cfg['network']['net_type'],
                  '2 + 2' if kind == 'ssl' else '2', WINDOW, med,
                  PARADIGM_STEPS, ['{0:.1f}'.format(t) for t in ms], peak,
                  '' if tflop is None else ', {0:.2f} TFLOP reckoned, {1:.1f} '
                  'TFLOP/s'.format(tflop, tflop / med * 1e3),
                  [['{0:.4f}'.format(v) for v in row] for row in losses]))
        del step, agent, net, batches
        torch.cuda.empty_cache()
    check(dsbn_prelu.launches == before, 'the {0} steps launched the '
          'DSBN+PReLU kernel'.format(kind))
    return results


PARADIGM_CLI_CFG = """
[dataset]
task_type = seg
root_dir = {root}
modal_num = 1
train_csv = {root}/{train_csv}
train_csv_unlab = {root}/unlab.csv
valid_csv = {root}/d1_valid.csv
test_csv = {root}/target_test.csv
train_batch_size = 2
train_batch_size_unlab = 2
train_transform = [NormalizeWithMeanStd, Pad, RandomCrop, RandomFlip, {label_transform}]
train_transform_unlab = [NormalizeWithMeanStd, Pad, RandomCrop, RandomFlip]
valid_transform = [NormalizeWithMeanStd, Pad, LabelToProbability]
test_transform = [NormalizeWithMeanStd, Pad]
NormalizeWithMeanStd_channels = [0]
Pad_output_size = {window}
RandomCrop_output_size = {window}
RandomCrop_foreground_focus = False
RandomFlip_flip_depth = False
RandomFlip_flip_height = True
RandomFlip_flip_width = True

[network]
net_type = UNet2D5
num_domains = 1
class_num = 2
in_chns = 1
feature_chns = {widths}
conv_dims = [2, 2, 3, 3, 3]
dropout = [0.0, 0.0, 0.3, 0.4, 0.5]
bilinear = False

[training]
loss_type = DiceLoss
optimizer = Adam
learning_rate = 1e-4
weight_decay = 1e-5
lr_scheduler = None
iter_start = {start}
iter_max = {stop}
iter_valid = {valid}
iter_save = {valid}
random_seed = 3
ckpt_save_dir = {root}/model/{tag}

[testing]
ckpt_mode = 0
output_dir = {root}/out_{tag}
sliding_window_enable = True
sliding_window_size = {window}
sliding_window_stride = {window}
tta_mode = 1
patch_chunk = 2

[{section}]
{key} = {method}
regularize_w = 0.1
rampup_start = 0
rampup_end = 6
{extra}
{evaluation}
"""


def paradigm_cli_cfg(root, kind, method, tag, start=0, stop=2, valid=2,
                     train_csv='d1_train.csv',
                     label_transform='LabelToProbability', extra='',
                     evaluation=''):
    """The config file of one run: checkpoints under ``model/{tag}``,
    labels under ``out_{tag}``; named after the tag and the start."""
    section, key, _ = PARADIGMS[kind]
    cfg = os.path.join(root, 'paradigm_{0}_{1}.cfg'.format(tag, start))
    with open(cfg, 'w') as f:
        f.write(PARADIGM_CLI_CFG.format(
            root=root, train_csv=train_csv, label_transform=label_transform,
            start=start, stop=stop, valid=valid, tag=tag, section=section,
            key=key, method=method, extra=extra, evaluation=evaluation,
            window=list(WINDOW), widths=PARADIGM_NET['feature_chns']))
    return cfg


def write_paradigm_workspace(root):
    """On phase 13's workspace: the unlabelled manifest (the two domain-0
    volumes) and scribbles cut from the phase-4 volumes' labels (10% of
    each class's voxels kept, the rest class 2, unlabelled)."""
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_nifti
    geom = ImageGeometry(origin=(0., 0., 0.), spacing=(0.4, 0.4, 1.5),
                         direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
    with open(os.path.join(root, 'unlab.csv'), 'w') as f:
        f.write('image\nsrc/case0.nii.gz\nsrc/case1.nii.gz\n')
    rs = np.random.RandomState(SEED + 220)
    rows = list(csv.reader(open(os.path.join(root, 'd1_train.csv'))))[1:]
    out = []
    for image, label in rows:
        lab = load_image_as_nd_array(os.path.join(root, label))[
            'data_array'][0]
        scribble = np.where(rs.uniform(size=lab.shape) < 0.1, lab, 2)
        name = label.replace('lab/', 'lab/scribble_')
        write_nifti(NiftiImage(scribble.astype(np.int16), geom),
                    os.path.join(root, name))
        out.append('{0},{1}\n'.format(image, name))
    with open(os.path.join(root, 'scribble_train.csv'), 'w') as f:
        f.write('image,label\n' + ''.join(out))


def paradigm_cli_phase(root, fwd_per_volume):
    """(23) The SSL and WSL CLIs at full width on phase 13's workspace:
    ``main_ssl train`` of MeanTeacher (6 iterations, validation and
    checkpoints every 3, the auto test stage on the phase-4 volumes and
    ``eva_main``); its resume from iteration 6 (one iteration), whose
    restored teacher must equal the saved one; ``main_wsl train`` of
    GatedCRF on scribbles (2 iterations); ``main_ssl test`` of CPS from a
    seeded BiNet checkpoint. Each run's kernel launches are counted."""
    from fpl_plus_torch import cli
    from fpl_plus_torch.agents.agent_seg import SegmentationAgent
    from fpl_plus_torch.agents.ssl import MeanTeacherStep, ParadigmAgent
    from fpl_plus_torch.agents.wsl import RegularizedStep
    from fpl_plus_torch.models.multi_net import make_binet
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    write_paradigm_workspace(root)
    restored = []
    orig_teacher = ParadigmAgent._make_teacher

    def capture(self):
        teacher = orig_teacher(self)
        restored.append({k: v.detach().cpu().clone()
                         for k, v in teacher.params.items()})
        return teacher

    ckpt = make_binet(PARADIGM_NET)
    init_random_(ckpt, SEED + 230)
    os.makedirs(os.path.join(root, 'model', 'cps'))
    torch.save({'iteration': 1, 'valid_pred': 0.0,
                'model_state_dict': ckpt.state_dict()},
               os.path.join(root, 'model', 'cps', 'cps_1.pt'))
    with open(os.path.join(root, 'model', 'cps', 'cps_latest.txt'),
              'w') as f:
        f.write('1')
    runs = {
        # tag: (main, stage, cfg, train steps, validations, step class)
        'mt': (cli.main_ssl, 'train', paradigm_cli_cfg(
            root, 'ssl', 'MeanTeacher', 'mt', 0, 6, 3,
            evaluation=EVAL_SECTION.format(root=root)), 6, 2,
            MeanTeacherStep),
        'mt_resume': (cli.main_ssl, 'train', paradigm_cli_cfg(
            root, 'ssl', 'MeanTeacher', 'mt', 6, 7, 1), 1, 1,
            MeanTeacherStep),
        'crf': (cli.main_wsl, 'train', paradigm_cli_cfg(
            root, 'wsl', 'GatedCRF', 'crf', 0, 2, 2,
            train_csv='scribble_train.csv',
            label_transform='PartialLabelToProbability'), 2, 1,
            RegularizedStep),
        'cps_test': (cli.main_ssl, 'test', paradigm_cli_cfg(
            root, 'ssl', 'CPS', 'cps'), 0, 0, None),
    }
    results = {}
    ParadigmAgent._make_teacher = capture
    try:
        for tag, (main, stage, cfg, steps, validations, step_cls) in \
                runs.items():
            step_ms, valid_ms, eval_s = [], [], []
            with contextlib.ExitStack() as stack:
                if step_cls is not None:
                    stack.enter_context(timed_method(step_cls, '__call__',
                                                     step_ms))
                stack.enter_context(timed_method(SegmentationAgent,
                                                 'validation', valid_ms))
                stack.enter_context(timed_function(cli, 'eva_main', eval_s))
                forwards = stack.enter_context(counting_forwards())
                torch.cuda.reset_peak_memory_stats()
                dsbn_prelu.launches = 0  # this path's count starts here
                t0 = time.perf_counter()
                rc = main([stage, cfg])
                wall = time.perf_counter() - t0
                launches = dsbn_prelu.launches
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
            peers = 2 if tag == 'cps_test' else 1
            n_eval = (validations + 1) * N_VOLUMES * fwd_per_volume * peers
            check(rc == 0, '{0} rc {1}'.format(tag, rc))
            check(len(step_ms) == steps, '{0}: {1} steps'.format(
                tag, len(step_ms)))
            check(forwards[0] == n_eval and launches == 18 * forwards[0]
                  and launches > 0, '{0}: {1} eval forwards (expected {2}), '
                  '{3} launches'.format(tag, forwards[0], n_eval, launches))
            labels = [n for n in os.listdir(os.path.join(
                root, 'out_' + tag.split('_')[0], tag.split('_')[0]
                + '_target_test')) if n.endswith('.nii.gz')]
            check(len(labels) == N_VOLUMES, '{0} labels {1}'.format(
                tag, labels))
            if tag == 'mt':      # before the resume's checkpoints
                saved = torch.load(os.path.join(root, 'model', 'mt',
                                                'mt_6.pt'),
                                   map_location='cpu', weights_only=False)
            results[tag] = {'launches': launches, 'forwards': forwards[0],
                            'step_ms': step_ms, 'valid_ms': valid_ms,
                            'eval_s': eval_s, 'wall_s': wall,
                            'peak_gib': peak}
            print('paradigm cli {0} ({1} {2}): {3} steps at {4} ms, {5} '
                  'validations at {6} ms ({7} volumes each), eva_main {8}, '
                  '{9} eval forwards, {10} kernel launches, peak {11:.2f} '
                  'GiB, {12:.1f} s wall'.format(
                      tag, main.__name__, stage, len(step_ms),
                      ['{0:.1f}'.format(t) for t in step_ms],
                      len(valid_ms), ['{0:.1f}'.format(t) for t in valid_ms],
                      N_VOLUMES, ['{0:.2f} s'.format(t) for t in eval_s],
                      forwards[0], launches, peak, wall))
    finally:
        ParadigmAgent._make_teacher = orig_teacher
    teacher = saved['ema_state_dict']
    check(len(restored) == 2 and set(restored[1]) == set(teacher)
          and all(torch.equal(restored[1][k], v) for k, v in teacher.items()),
          'the resumed teacher differs from the saved one')
    student = saved['model_state_dict']
    drift = max(float((teacher[k] - student[k]).abs().max())
                for k in teacher)
    check(drift > 0, 'the saved teacher equals the student')
    dice = read_csv(os.path.join(root, 'out_mt', 'mt_target_test',
                                 'test_block_dice_all.csv'))
    check(len(dice) == N_VOLUMES + 3 and all(
        np.isfinite(float(r[1])) for r in dice[1:]), 'dice {0}'.format(dice))
    print('paradigm cli: the resumed teacher equals the saved one '
          '({0} tensors; max |teacher - student| {1:.3g} at iteration 6); '
          'MeanTeacher dice {2}'.format(len(teacher), drift, dice[-2][1]))
    return results


NLL_METHODS = ('CoTeaching', 'TriNet', 'DAST')
NLL_SECTION = {'co_teaching_select_ratio': 0.8, 'dast_rank_length': 2,
               'dast_select_ratio': 0.5, 'dast_dbc_w': 0.1, 'dast_st_w': 0.1,
               'rampup_start': 0, 'rampup_end': 10}
NLL_CHECK_STEPS = 6                       # DAST: the gates of 6 steps
# the check's seeds (weights; data is the next seed): DAST's opens its ST
# gate within the 6 steps, so that the gated term runs on both devices
NLL_CHECK_SEEDS = {'CoTeaching': SEED + 240, 'TriNet': SEED + 242,
                   'DAST': SEED + 742}
# a voxel whose CE ties the keep cutoff within this (absolute; CE ~ 1) may
# fall on either side of it on the card and on the CPU
MASK_TIE_TOL = 1e-5


def nll_config(method, widths=None, dropout=None, optimizer='Adam'):
    """The agent config of one NLL method: UNet2D5 at NET_CFG, one domain
    (a BiNet, or a TriNet of it)."""
    net = dict(PARADIGM_NET)
    if widths is not None:
        net['feature_chns'] = list(widths)
    if dropout is not None:
        net['dropout'] = [dropout] * len(net['feature_chns'])
    return {'dataset': {'task_type': 'seg'}, 'network': net,
            'training': {'loss_type': 'DiceLoss', 'optimizer': optimizer,
                         'learning_rate': 1e-4, 'weight_decay': 0.0,
                         'iter_max': 100},
            'testing': {},
            'noisy_label_learning': dict(NLL_SECTION, nll_method=method)}


def nll_agent(cfg, net, dev):
    from fpl_plus_torch.agents.nll import NLLMethodDict
    from fpl_plus_torch.engine.optim import create_optimizer
    agent = NLLMethodDict[cfg['noisy_label_learning']['nll_method']](
        cfg, 'train', dev)
    agent.module = net.to(dev).train()
    step = agent._build_step(create_optimizer(cfg['training'],
                                              net.parameters()), None)
    return agent, step


def nll_net(cfg, method, seed):
    from fpl_plus_torch.models.multi_net import make_binet, make_trinet
    net = (make_trinet if method == 'TriNet' else make_binet)(cfg['network'])
    init_random_(net, seed)
    return net


def noisy_crops(gen, n, crop):
    """``n`` seeded crops, their labels (the bright voxels), and the same
    labels with a corner block flipped (label noise)."""
    x = torch.randn((n, 1) + tuple(crop), generator=gen)
    lab = (x[:, 0] > 0.5).long()
    noisy = lab.clone()
    d, h, w = crop
    noisy[:, :d // 2, :h // 4, :w // 4] = 1 - noisy[:, :d // 2, :h // 4,
                                                    :w // 4]
    def one_hot(t):
        return F.one_hot(t, 2).movedim(-1, 1).float()
    return x, one_hot(lab), one_hot(noisy)


def nll_batches(method, gen, n, crop):
    """Host data of one step: ``(batch,)`` of ``n`` crops with noisy labels
    (CoTeaching, TriNet), or ``{'clean', 'noise'}`` of ``n // 2`` crops
    each (DAST)."""
    if method != 'DAST':
        x, _, noisy = noisy_crops(gen, n, crop)
        return ({'image': x, 'label_prob': noisy},)
    x, clean, _ = noisy_crops(gen, n // 2, crop)
    x1, _, noisy = noisy_crops(gen, n // 2, crop)
    return {'clean': {'image': x, 'label_prob': clean},
            'noise': {'image': x1, 'label_prob': noisy}}


def batches_to(batches, dev):
    if isinstance(batches, dict):
        return {k: {n: t.to(dev) for n, t in v.items()}
                for k, v in batches.items()}
    return tuple({n: t.to(dev) for n, t in b.items()} for b in batches)


@contextlib.contextmanager
def recorded_masks():
    """The small-loss masks the NLL steps build in the block, with their
    per-voxel CE and keep count, on the CPU."""
    from fpl_plus_torch.agents import nll
    orig = nll.keep_smallest_mask
    rec = []

    def recording(values, keep_n):
        mask = orig(values, keep_n)
        rec.append((values.cpu(), keep_n, mask.cpu()))
        return mask

    nll.keep_smallest_mask = recording
    try:
        yield rec
    finally:
        nll.keep_smallest_mask = orig


def masks_agree(got, want):
    """Voxels whose card and CPU masks differ, and whether every one of
    them ties the CPU's keep cutoff within MASK_TIE_TOL."""
    (_, keep_n, m_got), (ce, keep_w, m_want) = got, want
    check(keep_n == keep_w, 'keep counts {0} vs {1}'.format(keep_n, keep_w))
    differ = m_got != m_want
    cutoff = torch.sort(ce).values[max(keep_n - 1, 0)]
    ties = bool(((ce[differ] - cutoff).abs() <= MASK_TIE_TOL).all())
    return int(differ.sum()), ties


def nll_check(dev):
    """(24a) One step of CoTeaching and TriNet and 6 of DAST, card vs CPU
    at small widths: SGD at 0.01 (DAST's selection scores then move from
    step to step by far more than the card and the CPU differ, so that the
    rank queues decide alike), TF32 off, dropout 0, heads scaled
    (``scale_heads_``), 2 crops of PARADIGM_CROP with noisy labels (DAST 1
    + 1). The small-loss masks identical (a voxel may differ only where
    its CE ties the keep cutoff within MASK_TIE_TOL), DAST's gate sequence
    identical; the first step's loss components, gradients and BN
    statistics by phase 11's tolerances."""
    results = {}
    for method in NLL_METHODS:
        cfg = nll_config(method, ZOO_SMALL, 0.0, 'SGD')
        cfg['training']['learning_rate'] = 0.01
        net = nll_net(cfg, method, NLL_CHECK_SEEDS[method])
        scale_heads_(net)
        host = nll_batches(method, torch.Generator().manual_seed(
            NLL_CHECK_SEEDS[method] + 10), 2, PARADIGM_CROP)
        steps = NLL_CHECK_STEPS if method == 'DAST' else 1
        out = []
        for where in (dev, torch.device('cpu')):
            agent, step = nll_agent(cfg, copy.deepcopy(net), where)
            batches = batches_to(host, where)
            gates, first = [], None
            with tf32_off(), recorded_masks() as masks:
                for it in range(steps):
                    hyper = agent.training_hyper(PARADIGM_IT + it)
                    gates.append(tuple(sorted(hyper.items())))
                    m = step(batches, agent._step_generators(PARADIGM_IT),
                             **hyper)
                    if it == 0:      # copies: later steps update in place
                        module = agent.module
                        first = {
                            'metrics': {k: v.cpu().clone()
                                        for k, v in m.items()},
                            'grads': {k: p.grad.cpu().clone() for k, p in
                                      module.named_parameters()},
                            'stats': {k: b.cpu().clone() for k, b in
                                      module.named_buffers() if k.endswith(
                                          ('running_mean', 'running_var'))}}
                if where.type == 'cuda':
                    torch.cuda.synchronize()
            out.append(dict(first, gates=gates, masks=masks))
        got, want = out
        keys = [k for k in want['metrics'] if k != 'class_dice_0']
        loss_err = max(abs(float(got['metrics'][k] - want['metrics'][k]))
                       for k in keys)
        dice_err = float((got['metrics']['class_dice_0']
                          - want['metrics']['class_dice_0']).abs().max())
        top = max(float(g.abs().max()) for g in want['grads'].values())
        worst, worst_name = 0.0, None
        for name, g in got['grads'].items():
            ref = want['grads'][name]
            ratio = float((g - ref).abs().max()) / (
                GRAD_RTOL * float(ref.abs().max()) + GRAD_NET_TOL * top)
            if ratio > worst:
                worst, worst_name = ratio, name
        stats_err = max(float((got['stats'][k] - b).abs().max())
                        / max(float(b.abs().max()), 1e-12)
                        for k, b in want['stats'].items())
        mask_diff = [masks_agree(a, b) for a, b in zip(got['masks'],
                                                       want['masks'])]
        check(len(got['masks']) == len(want['masks']),
              '{0}: {1} vs {2} masks'.format(method, len(got['masks']),
                                             len(want['masks'])))
        open_gates = sum(1 for g in want['gates']
                         if dict(g).get('w_dbc') or dict(g).get('w_st'))
        print('nll {0} card vs CPU (widths {1}, crop {2}, SGD, TF32 off, {3} '
              'step(s)): loss {4!r} vs {5!r}, max abs err of {6} {7:.3g} '
              '(tolerance {8}); class dice err {9:.3g}; worst gradient {10} '
              'at {11:.3g} of its tolerance; BN statistics max rel err '
              '{12:.3g}; masks differing voxels {13} (all at a tie of the '
              'cutoff: {14}); {15}'.format(
                  method, ZOO_SMALL, list(PARADIGM_CROP), steps,
                  float(got['metrics']['loss']),
                  float(want['metrics']['loss']), '/'.join(keys), loss_err,
                  STEP_LOSS_TOL, dice_err, worst_name, worst, stats_err,
                  [d for d, _ in mask_diff], all(t for _, t in mask_diff),
                  'gates per step {0}'.format([dict(g) for g in
                                               want['gates']])
                  if method == 'DAST' else 'remb_ratio {0}'.format(
                      dict(want['gates'][0])['remb_ratio'])))
        check(loss_err <= STEP_LOSS_TOL, 'nll {0} loss disagrees'.format(
            method))
        check(dice_err <= STEP_DICE_TOL, 'nll {0} dice disagrees'.format(
            method))
        check(worst <= 1.0, 'nll {0} gradient {1} disagrees'.format(
            method, worst_name))
        check(stats_err <= STATS_TOL, 'nll {0} BN statistics disagree'.format(
            method))
        check(all(d == 0 or t for d, t in mask_diff),
              'nll {0} masks disagree off the cutoff: {1}'.format(
                  method, mask_diff))
        check(got['gates'] == want['gates'], 'nll {0} gates {1} vs {2}'.format(
            method, got['gates'], want['gates']))
        check(method != 'DAST' or open_gates > 0,
              'DAST opened no gate in {0} steps'.format(steps))
        results[method] = {'loss_err': loss_err, 'grad_worst': worst,
                           'stats_err': stats_err,
                           'mask_diff': [d for d, _ in mask_diff],
                           'open_gates': open_gates}
    return results


def nll_timed(dev, macs):
    """(24b) Each NLL method for PARADIGM_STEPS steps at full width:
    UNet2D5 at NET_CFG (one domain), 4 crops of WINDOW with noisy labels
    (DAST 2 clean + 2 noisy), Adam, the network's dropout; CUDA-event ms
    per step (median of steps 2-3), peak memory, TFLOP reckoned from phase
    3's MACs (4 rows x 3 per peer). No kernel launch."""
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    before = dsbn_prelu.launches
    results = {}
    for i, method in enumerate(NLL_METHODS):
        cfg = nll_config(method)
        net = nll_net(cfg, method, SEED + 260 + i)
        agent, step = nll_agent(cfg, net, dev)
        batches = batches_to(nll_batches(method, torch.Generator()
                                         .manual_seed(SEED + 270 + i), 4,
                                         WINDOW), dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ms, losses = [], []
        for k in range(PARADIGM_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step(batches, agent._step_generators(k),
                     **agent.training_hyper(k))
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(m['loss']))
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        check(np.isfinite(losses).all(), 'nll {0} losses {1}'.format(
            method, losses))
        med = float(np.median(ms[1:]))
        peers = 3 if method == 'TriNet' else 2
        tflop = 2 * macs * 3 * 4 * peers / 1e12
        results[method] = {'ms': med, 'ms_all': ms, 'peak_gib': peak,
                           'tflop': tflop, 'losses': losses}
        print('nll {0} step at full width (UNet2D5 x {1} peers, {2} crops '
              '{3}): {4:.2f} ms (median of steps 2-{5}; all {6}), peak '
              '{7:.2f} GiB, {8:.2f} TFLOP reckoned, {9:.1f} TFLOP/s, losses '
              '{10}'.format(method, peers, '2 + 2' if method == 'DAST'
                            else '4', WINDOW, med, PARADIGM_STEPS,
                            ['{0:.1f}'.format(t) for t in ms], peak, tflop,
                            tflop / med * 1e3,
                            ['{0:.4f}'.format(v) for v in losses]))
        del step, agent, net, batches
        torch.cuda.empty_cache()
    check(dsbn_prelu.launches == before, 'the NLL steps launched the '
          'DSBN+PReLU kernel')
    return results


NLL_CLI_CFG = """
[dataset]
task_type = seg
root_dir = {root}
modal_num = 1
train_csv = {root}/{train_csv}
train_csv_noise = {root}/d1_train_noisy.csv
valid_csv = {root}/d1_valid.csv
test_csv = {root}/target_test.csv
train_batch_size = 2
train_batch_size_noise = 2
train_transform = [NormalizeWithMeanStd, Pad, RandomCrop, RandomFlip, LabelToProbability]
valid_transform = [NormalizeWithMeanStd, Pad, LabelToProbability]
test_transform = [NormalizeWithMeanStd, Pad]
NormalizeWithMeanStd_channels = [0]
Pad_output_size = {window}
RandomCrop_output_size = {window}
RandomCrop_foreground_focus = False
RandomFlip_flip_depth = False
RandomFlip_flip_height = True
RandomFlip_flip_width = True

[network]
net_type = {net_type}
num_domains = {domains}
class_num = 2
in_chns = 1
feature_chns = {widths}
conv_dims = [2, 2, 3, 3, 3]
dropout = [0.0, 0.0, 0.3, 0.4, 0.5]
bilinear = False

[training]
loss_type = {loss}
{loss_extra}
optimizer = Adam
learning_rate = 1e-4
weight_decay = 1e-5
lr_scheduler = None
iter_max = {stop}
iter_valid = 2
iter_save = 2
random_seed = 3
ckpt_save_dir = {root}/model/{tag}

[testing]
ckpt_mode = {mode}
{ckpt_name}
domian_label = {domain}
output_dir = {root}/out_{tag}
sliding_window_enable = True
sliding_window_size = {window}
sliding_window_stride = {window}
tta_mode = 1
patch_chunk = 2
cl_type = both

[noisy_label_learning]
nll_method = {method}
co_teaching_select_ratio = 0.8
dast_rank_length = 2
dast_select_ratio = 0.5
rampup_start = 0
rampup_end = 4
{evaluation}
"""


def nll_cli_cfg(root, tag, method='CoTeaching', stop=4,
                train_csv='d1_train_noisy.csv', loss='DiceLoss',
                loss_extra='', evaluation='', clslsr=False):
    """One run's config: checkpoints under ``model/{tag}``, labels under
    ``out_{tag}``. ``clslsr``: phase 13's generator (UNet2D5_dsbn, two
    banks, ``train_4.pt``) read on domain 1."""
    cfg = os.path.join(root, 'nll_{0}.cfg'.format(tag))
    net = NET_CFG if clslsr else PARADIGM_NET
    with open(cfg, 'w') as f:
        f.write(NLL_CLI_CFG.format(
            root=root, train_csv=train_csv, window=list(WINDOW),
            net_type=net['net_type'], domains=net['num_domains'],
            widths=net['feature_chns'], loss=loss, loss_extra=loss_extra,
            stop=stop, tag=tag, mode=2 if clslsr else 0,
            ckpt_name='ckpt_name = {0}/model/train/train_4.pt'.format(root)
            if clslsr else '', domain=DOMAIN if clslsr else 0,
            method=method, evaluation=evaluation))
    return cfg


def write_noisy_labels(root):
    """(25a) ``python -m fpl_plus_torch.utils.make_noise`` over phase 13's
    label volumes into ``lab_noisy/``, and ``d1_train_noisy.csv``."""
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'fpl_plus_torch.utils.make_noise',
         os.path.join(root, 'lab'), os.path.join(root, 'lab_noisy'),
         '--seed', str(SEED % 10000)], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, 'make_noise rc {0}: {1}'.format(
        proc.returncode, proc.stderr[-2000:]))
    rows = list(csv.reader(open(os.path.join(root, 'd1_train.csv'))))[1:]
    changed = []
    with open(os.path.join(root, 'd1_train_noisy.csv'), 'w') as f:
        f.write('image,label\n')
        for image, label in rows:
            noisy = label.replace('lab/', 'lab_noisy/')
            f.write('{0},{1}\n'.format(image, noisy))
            a = load_image_as_nd_array(os.path.join(root, label))
            b = load_image_as_nd_array(os.path.join(root, noisy))
            check(a['data_array'].shape == b['data_array'].shape,
                  'noisy label shape')
            changed.append(int((a['data_array'] != b['data_array']).sum()))
    check(sum(changed) > 0, 'make_noise changed no voxel')
    print('make_noise: {0} ({1:.1f} s): voxels changed per label {2}'.format(
        proc.stdout.strip(), wall, changed))
    return changed


def check_conf_maps(root, csv_name):
    """(25d) The ``slsr_conf/`` maps of a manifest's labels: present, in
    {0, 255}, of the label volumes' shapes; the ``_clslsr.csv`` rows."""
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    rows = list(csv.reader(open(os.path.join(root, csv_name))))[1:]
    flagged = []
    for _, label in rows:
        conf = load_image_as_nd_array(os.path.join(
            root, 'slsr_conf', os.path.basename(label)))['data_array']
        lab = load_image_as_nd_array(os.path.join(root, label))['data_array']
        check(conf.shape == lab.shape, 'map shape {0} vs label {1}'.format(
            conf.shape, lab.shape))
        check(set(np.unique(conf).tolist()) <= {0, 255}, 'map values')
        flagged.append(int((conf > 0).sum()))
    manifest = list(csv.reader(open(os.path.join(
        root, csv_name.replace('.csv', '_clslsr.csv')))))
    check(manifest[0] == ['image', 'pixel_weight', 'label']
          and [r[0] for r in manifest[1:]] == [r[0] for r in rows]
          and all(r[1] == 'slsr_conf/' + os.path.basename(r[2])
                  for r in manifest[1:]), 'manifest {0}'.format(manifest))
    return flagged


def nll_cli_phase(root, fwd_per_volume):
    """(25) The NLL CLIs at full width on phase 13's workspace: the noisy
    labels; ``cli nll train`` of CoTeaching on them (4 iterations,
    validation and checkpoints every 2, the auto test stage and
    ``eva_main``); ``cli nll train`` of DAST with ``train_csv_noise``;
    ``cli nll test`` of a seeded TriNet checkpoint; ``cli nll_clslsr`` over
    phase 13's train manifest with its generator checkpoint; a 2-iteration
    ``cli train`` with SLSRLoss on the written manifest. Each run's
    launches equal 18 x the UNet2D5 eval forwards (a BiNet forward: 2 of
    them, 36 launches; a TriNet's: 3, 54 launches)."""
    from fpl_plus_torch import cli
    from fpl_plus_torch.agents.agent_seg import SegmentationAgent
    from fpl_plus_torch.agents.nll import CoTeachingStep, DASTStep
    from fpl_plus_torch.engine.train import AlternatingTrainStep
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    from fpl_plus_torch.models.multi_net import make_trinet
    changed = write_noisy_labels(root)
    trinet = make_trinet(PARADIGM_NET)
    init_random_(trinet, SEED + 235)
    os.makedirs(os.path.join(root, 'model', 'trinet'))
    torch.save({'iteration': 1, 'valid_pred': 0.0,
                'model_state_dict': trinet.state_dict()},
               os.path.join(root, 'model', 'trinet', 'trinet_1.pt'))
    with open(os.path.join(root, 'model', 'trinet', 'trinet_latest.txt'),
              'w') as f:
        f.write('1')
    runs = {
        # tag: (main, argv, train steps, validations, peers, test volumes)
        'cot': (cli.main_nll, ['train', nll_cli_cfg(
            root, 'cot', evaluation=EVAL_SECTION.format(root=root))], 4, 2,
            2, N_VOLUMES, CoTeachingStep),
        'dast': (cli.main_nll, ['train', nll_cli_cfg(
            root, 'dast', 'DAST', 2, train_csv='d1_train.csv')], 2, 1, 2,
            N_VOLUMES, DASTStep),
        'trinet': (cli.main_nll, ['test', nll_cli_cfg(
            root, 'trinet', 'TriNet')], 0, 0, 3, N_VOLUMES, None),
        'clslsr': (cli.main_nll_clslsr, ['test', nll_cli_cfg(
            root, 'clslsr', train_csv='d1_train.csv', clslsr=True)], 0, 0, 1,
            N_VOLUMES, None),
        'slsr': (cli.main, ['train', nll_cli_cfg(
            root, 'slsr', stop=2, train_csv='d1_train_clslsr.csv',
            loss='SLSRLoss',
            loss_extra='train_fpl_uda = True\nslsrloss_epsilon = 0.25')],
            2, 1, 1, N_VOLUMES, AlternatingTrainStep),
    }
    results = {}
    for tag, (main, argv, steps, validations, peers, tests, step_cls) in \
            runs.items():
        step_ms, valid_ms, eval_s = [], [], []
        with contextlib.ExitStack() as stack:
            if step_cls is not None:
                stack.enter_context(timed_method(step_cls, '__call__',
                                                 step_ms))
            stack.enter_context(timed_method(SegmentationAgent, 'validation',
                                             valid_ms))
            stack.enter_context(timed_function(cli, 'eva_main', eval_s))
            forwards = stack.enter_context(counting_forwards())
            torch.cuda.reset_peak_memory_stats()
            dsbn_prelu.launches = 0      # this path's count starts here
            t0 = time.perf_counter()
            rc = main(argv)
            wall = time.perf_counter() - t0
            launches = dsbn_prelu.launches
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_eval = (validations * N_VOLUMES + tests) * fwd_per_volume * peers
        check(rc == 0, 'nll cli {0} rc {1}'.format(tag, rc))
        check(len(step_ms) == steps, 'nll cli {0}: {1} steps'.format(
            tag, len(step_ms)))
        check(forwards[0] == n_eval and launches == 18 * forwards[0]
              and launches > 0, 'nll cli {0}: {1} eval forwards (expected '
              '{2}), {3} launches'.format(tag, forwards[0], n_eval,
                                          launches))
        if tag != 'clslsr':
            labels = [n for n in os.listdir(os.path.join(
                root, 'out_' + tag, tag + '_target_test'))
                if n.endswith('.nii.gz')]
            check(len(labels) == N_VOLUMES, 'nll cli {0} labels {1}'.format(
                tag, labels))
        results[tag] = {'launches': launches, 'forwards': forwards[0],
                        'step_ms': step_ms, 'valid_ms': valid_ms,
                        'eval_s': eval_s, 'wall_s': wall, 'peak_gib': peak}
        print('nll cli {0} ({1} {2}): {3} steps at {4} ms, {5} validations '
              'at {6} ms ({7} volumes each), eva_main {8}, {9} eval '
              'forwards, {10} kernel launches, peak {11:.2f} GiB, {12:.1f} s '
              'wall'.format(tag, main.__name__, argv[0], len(step_ms),
                            ['{0:.1f}'.format(t) for t in step_ms],
                            len(valid_ms),
                            ['{0:.1f}'.format(t) for t in valid_ms],
                            N_VOLUMES,
                            ['{0:.2f} s'.format(t) for t in eval_s],
                            forwards[0], launches, peak, wall))
        if tag == 'clslsr':
            flagged = check_conf_maps(root, 'd1_train.csv')
            results[tag]['flagged'] = flagged
            print('nll cli clslsr: slsr_conf maps of {0} labels in {{0, 255}} '
                  'at the label shape {1}; voxels flagged noisy per volume '
                  '{2}; manifest d1_train_clslsr.csv'.format(
                      len(flagged), list(VOLUME), flagged))
    dice = read_csv(os.path.join(root, 'out_cot', 'cot_target_test',
                                 'test_block_dice_all.csv'))
    check(len(dice) == N_VOLUMES + 3 and all(
        np.isfinite(float(r[1])) for r in dice[1:]), 'dice {0}'.format(dice))
    results['noise_changed'] = changed
    return results


CLS_ARCHS = ('resnet18', 'vgg16', 'mobilenetv2')
CLS_CHECK_HW = 64                          # the card-vs-CPU check's images
# the cls nets' running statistics after one step, card vs CPU: 0.1 x the
# batch moments of activations that the two compute in other orders
# through up to 52 layers, held like the forward's activations (phase 3's
# FWD_TOL, against the tensor's max |value|). MobileNetV2's differed by
# 1.98e-05 of that on an NVIDIA H100 80GB HBM3 at 700 W (its eval logits
# by 1.9e-05 of theirs), over the UNet2D5 steps' STATS_TOL.
CLS_STATS_TOL = FWD_TOL
CLS_HW, CLS_BATCH = 224, 8                 # the timed steps


def cls_net(arch, seed, class_num=2, chns=3):
    from fpl_plus_torch.models.cls_nets import TorchClsNetDict
    net = TorchClsNetDict[arch]({'class_num': class_num, 'input_chns': chns})
    init_random_(net, seed)
    return net


def cls_check(dev):
    """(26a) Each cls net card vs CPU on one state dict, TF32 off: an eval
    forward of 2 RGB images of CLS_CHECK_HW (phase 3's tolerance) and one
    SGD step in train mode without dropout generators (no dropout drawn):
    loss and gradients by phase 11's tolerances, BN statistics by
    CLS_STATS_TOL."""
    from fpl_plus_torch.losses.cls import CrossEntropyLoss
    results = {}
    gen = torch.Generator().manual_seed(SEED + 280)
    x = torch.randn((2, 3, CLS_CHECK_HW, CLS_CHECK_HW), generator=gen)
    labels = torch.tensor([0, 1])
    for i, arch in enumerate(CLS_ARCHS):
        net = cls_net(arch, SEED + 290 + i)
        out = []
        for where in (dev, torch.device('cpu')):
            m = copy.deepcopy(net).to(where)
            with tf32_off():
                with torch.no_grad():
                    logits = m.eval()(x.to(where)).cpu()
                m.train()
                opt = torch.optim.SGD(m.parameters(), lr=0.01)
                opt.zero_grad()
                loss = CrossEntropyLoss()({'prediction': m(x.to(where)),
                                           'ground_truth': labels.to(where)})
                loss.backward()
                opt.step()
            out.append({'logits': logits, 'loss': float(loss.detach()),
                        'grads': {k: p.grad.cpu()
                                  for k, p in m.named_parameters()},
                        'stats': {k: b.cpu() for k, b in m.named_buffers()
                                  if k.endswith(('running_mean',
                                                 'running_var'))}})
        got, want = out
        fwd_err = float((got['logits'] - want['logits']).abs().max())
        scale = float(want['logits'].abs().max())
        top = max(float(g.abs().max()) for g in want['grads'].values())
        worst, worst_name = 0.0, None
        for name, g in got['grads'].items():
            ref = want['grads'][name]
            ratio = float((g - ref).abs().max()) / (
                GRAD_RTOL * float(ref.abs().max()) + GRAD_NET_TOL * top)
            if ratio > worst:
                worst, worst_name = ratio, name
        stats_err = max((float((got['stats'][k] - b).abs().max())
                         / max(float(b.abs().max()), 1e-12)
                         for k, b in want['stats'].items()), default=0.0)
        loss_err = abs(got['loss'] - want['loss'])
        print('cls {0} card vs CPU ({1}x{1}, TF32 off): eval logits max abs '
              'err {2:.3g} (|logit| max {3:.3g}); SGD step loss {4!r} vs '
              '{5!r}, err {6:.3g}; worst gradient {7} at {8:.3g} of its '
              'tolerance; BN statistics max rel err {9:.3g}'.format(
                  arch, CLS_CHECK_HW, fwd_err, scale, got['loss'],
                  want['loss'], loss_err, worst_name, worst, stats_err))
        check(fwd_err <= FWD_TOL * max(1.0, scale), 'cls {0} forward '
              'disagrees'.format(arch))
        check(loss_err <= STEP_LOSS_TOL, 'cls {0} loss disagrees'.format(arch))
        check(worst <= 1.0, 'cls {0} gradient {1} disagrees'.format(
            arch, worst_name))
        check(stats_err <= CLS_STATS_TOL, 'cls {0} BN statistics '
              'disagree'.format(arch))
        results[arch] = {'fwd_err': fwd_err, 'grad_worst': worst,
                         'stats_err': stats_err}
    return results


def cls_timed(dev):
    """(26b) Each cls net through the agent's ``train_step`` at
    CLS_BATCH x 3 x CLS_HW^2, Adam, its dropout: CUDA-event ms per step
    (median of steps 2-3), peak memory, TFLOP reckoned from the module
    shapes (forward MACs x 2 x 3). No kernel launch."""
    from fpl_plus_torch.agents.agent_cls import ClassificationAgent
    from fpl_plus_torch.engine.optim import create_optimizer
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    before = dsbn_prelu.launches
    gen = torch.Generator().manual_seed(SEED + 300)
    x = torch.randn((CLS_BATCH, 3, CLS_HW, CLS_HW), generator=gen).to(dev)
    labels = torch.randint(0, 2, (CLS_BATCH,), generator=gen).to(dev)
    results = {}
    for i, arch in enumerate(CLS_ARCHS):
        cfg = {'dataset': {'task_type': 'cls'},
               'network': {'net_type': arch, 'class_num': 2,
                           'input_chns': 3},
               'training': {'optimizer': 'Adam', 'learning_rate': 1e-4,
                            'weight_decay': 0.0,
                            'loss_type': 'CrossEntropyLoss'},
               'testing': {}}
        agent = ClassificationAgent(cfg, 'train', dev)
        agent.module = cls_net(arch, SEED + 310 + i).to(dev)
        with counting_macs(agent.module) as macs, torch.no_grad():
            agent.module.eval()(x[:1])
        agent.module.train()
        optimizer = create_optimizer(cfg['training'],
                                     agent.module.parameters())
        loss_calc = agent._loss_calculator()
        torch.cuda.reset_peak_memory_stats(dev)
        ms, losses = [], []
        for k in range(PARADIGM_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss, _ = agent.train_step(optimizer, loss_calc, x, labels, k)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        check(np.isfinite(losses).all(), 'cls {0} losses {1}'.format(
            arch, losses))
        med = float(np.median(ms[1:]))
        tflop = 2 * macs[0] * CLS_BATCH * 3 / 1e12
        results[arch] = {'ms': med, 'ms_all': ms, 'peak_gib': peak,
                         'tflop': tflop}
        print('cls {0} train step (batch {1} x 3 x {2}^2, Adam): {3:.2f} ms '
              '(median of steps 2-{4}; all {5}), peak {6:.2f} GiB, {7:.3f} '
              'TFLOP reckoned, {8:.1f} TFLOP/s, losses {9}'.format(
                  arch, CLS_BATCH, CLS_HW, med, PARADIGM_STEPS,
                  ['{0:.1f}'.format(t) for t in ms], peak, tflop,
                  tflop / med * 1e3, ['{0:.4f}'.format(v) for v in losses]))
        del agent, optimizer
        torch.cuda.empty_cache()
    check(dsbn_prelu.launches == before, 'the cls steps launched the '
          'DSBN+PReLU kernel')
    return results


CLS_CLI_CFG = """
[dataset]
task_type = cls
root_dir = {root}
modal_num = 1
train_csv = {root}/cls_train.csv
valid_csv = {root}/cls_valid.csv
test_csv = {root}/cls_test.csv
train_batch_size = 8

[network]
net_type = resnet18
class_num = 2
input_chns = 3

[training]
loss_type = CrossEntropyLoss
optimizer = Adam
learning_rate = 1e-3
weight_decay = 0.0
lr_scheduler = ReduceLROnPlateau
lr_gamma = 0.5
ReduceLROnPlateau_patience = 6
iter_max = 6
iter_valid = 3
random_seed = 3
ckpt_save_dir = {root}/model/cls

[testing]
ckpt_mode = 1
output_csv = {root}/cls_pred.csv
save_probability = True

[evaluation]
task_type = cls
metric_list = [accuracy, recall, specificity, precision, auc]
ground_truth_csv = {root}/cls_test_gt.csv
predict_prob_csv = {root}/cls_pred_prob.csv
"""


def write_cls_workspace(root, n=40, hw=CLS_CHECK_HW):
    """``n`` seeded RGB PNGs, bright (label 1) or dark (label 0), split
    24 / 8 / 8 into the train, valid and test manifests (and the test
    labels for ``main_eval_cls``)."""
    from PIL import Image
    rs = np.random.RandomState(SEED + 320)
    os.makedirs(os.path.join(root, 'cls_img'))
    rows = []
    for i in range(n):
        label = i % 2
        img = np.clip(rs.normal(80 + 90 * label, 30, (hw, hw, 3)), 0,
                      255).astype(np.uint8)
        name = 'cls_img/c{0}.png'.format(i)
        Image.fromarray(img).save(os.path.join(root, name))
        rows.append((name, label))
    splits = {'cls_train': rows[:24], 'cls_valid': rows[24:32],
              'cls_test_gt': rows[32:]}
    for split, part in splits.items():
        with open(os.path.join(root, split + '.csv'), 'w') as f:
            f.write('image,label\n' + ''.join('{0},{1}\n'.format(*r)
                                              for r in part))
    with open(os.path.join(root, 'cls_test.csv'), 'w') as f:
        f.write('image\n' + ''.join(r[0] + '\n' for r in rows[32:]))
    with open(os.path.join(root, 'cls.cfg'), 'w') as f:
        f.write(CLS_CLI_CFG.format(root=root))
    return os.path.join(root, 'cls.cfg')


def cls_cli_phase(root):
    """(26c) ``cli train`` of ResNet18 with ``task_type = cls`` on RGB PNGs
    (6 iterations of 8, validation and checkpoints every 3, the plateau
    controller), ``cli test`` from the best checkpoint (the output and
    probability CSVs; at least 6 of the 8 test images classed right),
    ``main_eval_cls`` on them; no kernel launch."""
    import PIL
    from fpl_plus_torch import cli
    from fpl_plus_torch.agents.agent_cls import ClassificationAgent
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    print('cls cli: PIL {0} imports on this host; the workspace is PNG '
          'images'.format(PIL.__version__))
    cfg = write_cls_workspace(root)
    step_ms = []
    t0 = time.perf_counter()
    with timed_method(ClassificationAgent, 'train_step', step_ms):
        dsbn_prelu.launches = 0          # this path's count starts here
        rc_train = cli.main(['train', cfg])
        rc_test = cli.main(['test', cfg])
        launches = dsbn_prelu.launches
    wall = time.perf_counter() - t0
    check(rc_train == 0 and rc_test == 0, 'cls cli rc {0} / {1}'.format(
        rc_train, rc_test))
    check(len(step_ms) == 6, 'cls cli steps {0}'.format(len(step_ms)))
    check(launches == 0, 'cls cli launched the kernel {0} times'.format(
        launches))
    model = os.path.join(root, 'model', 'cls')
    check({'cls_3.pt', 'cls_6.pt', 'cls_best.txt', 'cls_latest.txt'}
          <= set(os.listdir(model)), 'cls checkpoints {0}'.format(
              sorted(os.listdir(model))))
    pred = read_csv(os.path.join(root, 'cls_pred.csv'))
    prob = read_csv(os.path.join(root, 'cls_pred_prob.csv'))
    check(pred[0] == ['image', 'label'] and len(pred) == 9
          and all(r[1] in ('0', '1') for r in pred[1:]),
          'cls predictions {0}'.format(pred[:3]))
    check(prob[0] == ['image', 'prob0', 'prob1'] and len(prob) == 9
          and all(abs(float(r[1]) + float(r[2]) - 1) < 1e-5
                  for r in prob[1:]), 'cls probabilities {0}'.format(
                      prob[:3]))
    check(cli.main_eval_cls([os.path.join(root, 'cls.cfg')]) == 0,
          'main_eval_cls')
    report = read_csv(os.path.join(root, 'cls_pred_prob_eval.csv'))
    check([r[0] for r in report] == ['accuracy', 'recall', 'specificity',
                                     'precision', 'auc']
          and all(0.0 <= float(r[1]) <= 1.0 for r in report),
          'cls report {0}'.format(report))
    gt = read_csv(os.path.join(root, 'cls_test_gt.csv'))[1:]
    acc = float(np.mean([p[1] == g[1] for p, g in zip(pred[1:], gt)]))
    check(acc >= 0.75, 'cls cli learnt no bright/dark split: test accuracy '
          '{0}'.format(acc))
    print('cls cli: train steps {0} ms, {1} kernel launches, test '
          'accuracy {2:.3f}, report {3}, {4:.1f} s wall'.format(
              ['{0:.1f}'.format(t) for t in step_ms], launches, acc,
              {r[0]: float(r[1]) for r in report}, wall))
    return {'launches': launches, 'step_ms': step_ms, 'report': report,
            'wall_s': wall}


# phases 27-29: the loader's worker pool, the host tools, the converter
POOL_BATCHES = 8                 # phase 27's stream comparison
POOL_WORKERS = 8                 # num_workder of phase 27 (JAX's default)
PREPROCESS_PAD = [44, 168, 280]  # phase 28's preprocess chain
FIXTURE = os.path.join(REPO, 'tests', 'data', 'jax_ckpt')


def loader_workers():
    """The pids of the loader's worker processes alive now: the children of
    the multiprocessing forkserver, where the pool forks them."""
    from multiprocessing import forkserver
    server = forkserver._forkserver._forkserver_pid
    pids = []
    for entry in os.listdir('/proc') if server else ():
        try:
            with open('/proc/{0}/stat'.format(entry)) as f:
                ppid = int(f.read().rsplit(')', 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == server:
            pids.append(int(entry))
    return pids


@contextlib.contextmanager
def watching_pools(sink):
    """At each pool's shutdown, record its worker count, how many were
    alive, and the torch or CUDA libraries mapped in their processes."""
    from fpl_plus_torch.io.loader import DataLoader
    orig = DataLoader.shutdown

    def shutdown(self):
        if self._pool is not None:
            libs, alive = set(), 0
            for proc in self._pool:
                try:
                    with open('/proc/{0}/maps'.format(proc.pid)) as f:
                        libs.update(line.split()[-1] for line in f if any(
                            n in line for n in ('libtorch', 'libc10',
                                                'libcuda')))
                    alive += 1
                except OSError:
                    pass
            sink.append({'workers': len(self._pool), 'alive': alive,
                         'torch_libs': sorted(libs)})
        orig(self)

    DataLoader.shutdown = shutdown
    try:
        yield sink
    finally:
        DataLoader.shutdown = orig


def same_batch(a, b):
    if sorted(a) != sorted(b):
        return False
    for key, value in a.items():
        if isinstance(value, np.ndarray):
            if value.dtype != b[key].dtype or not np.array_equal(value,
                                                                 b[key]):
                return False
        elif value != b[key]:
            return False
    return True


def pool_phase(root, train, fwd_per_volume):
    """(27) The train loader's worker pool at full width: phase 13's
    flagship stream, synchronous against pooled, bit for bit and timed;
    then phase 13's generator ``cli train`` with ``num_workder = 8``."""
    from fpl_plus_torch import cli
    from fpl_plus_torch.agents.agent_seg import SegmentationAgent
    from fpl_plus_torch.config.parser import parse_config, synchronize_config
    from fpl_plus_torch.engine.train import JointTrainStep
    from fpl_plus_torch.io.loader import repeat_loader
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    expected = min(POOL_WORKERS, max((os.cpu_count() or 1) - 1, 0))
    streams = {}
    for workers in (0, POOL_WORKERS):
        cfg = train_cfg(root, 'pool_stream_{0}'.format(workers),
                        workers=workers)
        agent = SegmentationAgent(synchronize_config(parse_config(cfg)),
                                  'train', torch.device('cpu'))
        agent.create_dataset()
        loader = agent.train_loaders[1]     # domain 2: the phase-4 volumes
        stream = repeat_loader(loader)
        batches, stamps = [], [time.perf_counter()]
        try:
            for _ in range(POOL_BATCHES):
                batches.append(next(stream))
                stamps.append(time.perf_counter())
        finally:
            agent.shutdown()
        streams[workers] = {'workers': loader.num_workers,
                            'batches': batches,
                            's': stamps[-1] - stamps[0],
                            'steady_s': stamps[-1] - stamps[1]}
    check(streams[POOL_WORKERS]['workers'] == expected,
          'pool of {0} workers, expected {1}'.format(
              streams[POOL_WORKERS]['workers'], expected))
    equal = [same_batch(a, b) for a, b in zip(
        streams[0]['batches'], streams[POOL_WORKERS]['batches'])]
    check(all(equal), 'pooled batches differ from the synchronous ones: '
          '{0}'.format(equal))
    rates = {w: {'batches_per_s': POOL_BATCHES / r['s'],
                 'steady_batches_per_s': (POOL_BATCHES - 1) / r['steady_s']}
             for w, r in streams.items()}
    print('pool stream: {0} batches of {1} crops, pooled ({2} workers) equal '
          'to synchronous bit for bit; synchronous {3:.3f} batches/s '
          '({4:.3f} after the first), pooled {5:.3f} ({6:.3f})'.format(
              POOL_BATCHES, TRAIN_BATCH, expected,
              rates[0]['batches_per_s'], rates[0]['steady_batches_per_s'],
              rates[POOL_WORKERS]['batches_per_s'],
              rates[POOL_WORKERS]['steady_batches_per_s']))

    valid_volumes = 2 + N_VOLUMES
    cfg = train_cfg(root, 'pool', start=0, stop=4, ckpt='pool',
                    workers=POOL_WORKERS)
    step_ms, valid_ms, pools = [], [], []
    with timed_method(JointTrainStep, '__call__', step_ms), \
            timed_method(SegmentationAgent, 'validation', valid_ms), \
            counting_forwards() as forwards, watching_pools(pools):
        dsbn_prelu.launches = 0          # the main path's count starts here
        rc = cli.main(['train', cfg])
        launches = dsbn_prelu.launches
    check(rc == 0, 'pooled train stage rc {0}'.format(rc))
    n_eval = valid_volumes * 4 // 2 + N_VOLUMES
    check(forwards[0] == n_eval * fwd_per_volume,
          '{0} eval forwards in the pooled run, expected {1}'.format(
              forwards[0], n_eval * fwd_per_volume))
    check(launches == 18 * forwards[0], '{0} kernel launches for {1} eval '
          'forwards'.format(launches, forwards[0]))
    check(len(step_ms) == 4, '{0} train steps'.format(len(step_ms)))
    check([p['workers'] for p in pools] == [expected, expected]
          and all(p['alive'] == expected for p in pools),
          'pools at shutdown {0}, expected two of {1} live workers'.format(
              pools, expected))
    check(not any(p['torch_libs'] for p in pools),
          'torch or CUDA libraries in the workers: {0}'.format(pools))
    left = loader_workers()
    check(not left, 'loader workers alive after the run: {0}'.format(left))
    with open(os.path.join(root, 'model', 'pool', 'scalars.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    wait = [r['value'] for r in recs if r['tag'] == 'host_wait']
    losses = [r[k] for r in recs if r['tag'] == 'loss'
              for k in ('train', 'valid')]
    check(len(losses) == 4 and all(np.isfinite(losses)),
          'losses {0}'.format(losses))
    sync = train['gen']
    run = {'launches': launches, 'forwards': forwards[0], 'step_ms': step_ms,
           'host_wait_s': wait, 'valid_ms': [t / valid_volumes
                                             for t in valid_ms],
           'workers': expected, 'stream': rates}
    print('pool train (num_workder {0}: {1} workers per domain): steps {2} ms '
          '(synchronous phase 13: {3}), host wait per iteration {4} s '
          '({5}), validation {6} ms per volume ({7}); {8} eval forwards, {9} '
          'kernel launches; no worker alive after the run, none mapped torch'
          .format(POOL_WORKERS, expected,
                  ['{0:.1f}'.format(t) for t in step_ms],
                  ['{0:.1f}'.format(t) for t in sync['step_ms']],
                  ['{0:.4f}'.format(w) for w in wait],
                  ['{0:.4f}'.format(w) for w in sync['host_wait_s']],
                  ['{0:.1f}'.format(t) for t in run['valid_ms']],
                  ['{0:.1f}'.format(t) for t in sync['valid_ms']],
                  forwards[0], launches))
    return run


def host_tools_phase(root, names, fwd_per_volume):
    """(28) ``model_operate average`` of phase 13's checkpoints served by a
    ``ckpt_mode = 2`` test stage, a ``rename`` round trip, and the
    ``preprocess`` CLI against its chain applied in memory."""
    from fpl_plus_torch import cli
    from fpl_plus_torch.engine.ckpt import STATISTICS, load_checkpoint
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    from fpl_plus_torch.io.nifti import read_image
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    from fpl_plus_torch.utils import model_operate, preprocess
    ckpt_dir = os.path.join(root, 'model', 'train')
    train2, train4 = (os.path.join(ckpt_dir, 'train_{0}.pt'.format(i))
                      for i in (2, 4))
    avg = os.path.join(root, 'model', 'avg.pt')
    t0 = time.perf_counter()
    check(model_operate.main(['average', train2, train4, '--output',
                              avg]) == 0, 'model_operate average')
    average_s = time.perf_counter() - t0
    a, b, m = (load_checkpoint(p)['model_state_dict']
               for p in (train2, train4, avg))
    averaged = 0
    for key, value in a.items():
        if key.endswith(STATISTICS):
            want = value
        else:
            want = ((value.double() + b[key].double()) / 2).to(value.dtype)
            averaged += 1
        check(m[key].dtype == want.dtype and torch.equal(m[key], want),
              'averaged entry {0}'.format(key))
    check(averaged > 0 and any(not torch.equal(a[k], b[k]) for k in a),
          'nothing to average')

    cfg = write_cfg(root, 'avg', mode=2, extra='ckpt_name = ' + avg)
    with counting_forwards() as forwards:
        dsbn_prelu.launches = 0          # the main path's count starts here
        rc = cli.main(['test', cfg])
        launches = dsbn_prelu.launches
    check(rc == 0, 'averaged test stage rc {0}'.format(rc))
    check(forwards[0] == N_VOLUMES * fwd_per_volume and
          launches == 18 * forwards[0], 'averaged test stage: {0} launches '
          'for {1} forwards'.format(launches, forwards[0]))
    for name in names:
        lab = load_image_as_nd_array(os.path.join(
            root, 'out_avg', 'gen_target_test', os.path.basename(name)))[
            'data_array']
        check(lab.shape == (1,) + VOLUME and set(np.unique(lab)) <= {0, 1},
              'averaged labels {0} {1}'.format(lab.shape, np.unique(lab)))

    key = next(iter(a))
    there, back = (os.path.join(root, 'model', n)
                   for n in ('renamed.pt', 'back.pt'))
    check(model_operate.main(['rename', avg, there, '--from', key, '--to',
                              'renamed.' + key]) == 0, 'rename')
    check(next(iter(load_checkpoint(there)['model_state_dict']))
          == 'renamed.' + key, 'the renamed entry')
    check(model_operate.main(['rename', there, back, '--from',
                              'renamed.' + key, '--to', key]) == 0,
          'rename back')
    restored = load_checkpoint(back)['model_state_dict']
    check(list(restored) == list(m) and all(
        torch.equal(restored[k], m[k]) for k in m), 'rename round trip')

    chain = os.path.join(root, 'preprocess.cfg')
    with open(chain, 'w') as f:
        f.write('[dataset]\ntransform = [NormalizeWithMeanStd, Pad]\n'
                'NormalizeWithMeanStd_channels = [0]\n'
                'Pad_output_size = {0}\n'.format(PREPROCESS_PAD))
    src = os.path.join(root, names[0])
    out = os.path.join(root, 'preprocessed.nii.gz')
    t0 = time.perf_counter()
    check(preprocess.main([chain, src, out]) == 0, 'preprocess CLI')
    preprocess_s = time.perf_counter() - t0
    loaded = load_image_as_nd_array(src)
    sample = {'image': np.asarray(loaded['data_array'], np.float32),
              'origin': loaded['origin'], 'spacing': loaded['spacing'],
              'direction': loaded['direction']}
    for t in preprocess.get_transform_list(chain):
        sample = t(sample)
    written = read_image(out)
    check(written.data.shape == tuple(PREPROCESS_PAD)
          and np.array_equal(written.data, sample['image'][0]),
          'preprocess output {0} differs from the chain in memory'.format(
              written.data.shape))
    print('host tools: model_operate average of train_2 and train_4 in '
          '{0:.2f} s ({1} parameters averaged in float64, statistics from '
          'the first), its ckpt_mode 2 test stage {2} forwards / {3} kernel '
          'launches; rename round trip equal; preprocess CLI {4:.2f} s, '
          'equal to the chain in memory'.format(
              average_s, averaged, forwards[0], launches, preprocess_s))
    return {'launches': launches, 'forwards': forwards[0],
            'average_s': average_s, 'preprocess_s': preprocess_s}


def converter_phase(root, dev):
    """(29) ``cli convert`` of the committed JAX checkpoint, then the
    port's forward of its window on the card against JAX's logits."""
    from fpl_plus_torch import cli
    from fpl_plus_torch.config.parser import parse_config
    from fpl_plus_torch.engine.ckpt import load_checkpoint
    from fpl_plus_torch.models.registry import create_network
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    out = os.path.join(root, 'model', 'converted', 'converted_3.pt')
    check(cli.shell(['convert', os.path.join(FIXTURE, 'jax_3.ckpt'),
                     os.path.join(FIXTURE, 'net.cfg'), out]) == 0,
          'cli convert')
    check(not any(m.split('.')[0] in ('jax', 'flax', 'msgpack')
                  for m in sys.modules), 'JAX on the converter path')
    net = create_network(parse_config(os.path.join(
        FIXTURE, 'net.cfg'))['network']).eval()
    net.load_state_dict(load_checkpoint(out)['model_state_dict'],
                        strict=True)
    net = net.to(dev)
    window = np.load(os.path.join(FIXTURE, 'window.npz'))
    x = torch.from_numpy(window['x']).to(dev)
    errs = {}
    with tf32_off(), torch.inference_mode():
        for domain in (0, 1):
            dsbn_prelu.launches = 0      # the main path's count starts here
            got = net(x, domain).cpu().numpy()
            check(dsbn_prelu.launches == 18, 'converted forward launched '
                  'the kernel {0} times'.format(dsbn_prelu.launches))
            want = window['logits_d{0}'.format(domain)]
            check(got.shape == want.shape and bool(np.isfinite(got).all()),
                  'converted logits {0}'.format(got.shape))
            errs[domain] = float(np.abs(got - want).max())
            scale = float(np.abs(want).max())
            check(errs[domain] <= FWD_TOL * max(1.0, scale),
                  'converted forward disagrees with JAX on domain {0}: '
                  '{1}'.format(domain, errs[domain]))
    print('converter: JAX checkpoint {0} -> {1}; the card forward of its '
          'window, domains 0 / 1, max abs err against JAX\'s logits {2:.3g} '
          '/ {3:.3g} (tolerance {4} x max(1, |logit|)), 18 kernel launches '
          'each'.format(os.path.relpath(os.path.join(FIXTURE, 'jax_3.ckpt'),
                                        REPO), os.path.basename(out),
                        errs[0], errs[1], FWD_TOL))
    return {'launches': 36, 'max_abs_err': max(errs.values())}


DIST_RANKS = 2                   # phase 30: ranks sharing cuda:0
# phase 30: the 6-pass fold's seeds and the reduction's selection margins
DIST_PASS_SEEDS = [SEED + 300 + i for i in range(FPL_PASSES)]
DIST_MARGINS = ([2, 5, 3], [1, 0, 7])
DIST_SW = {'sliding_window_enable': True, 'sliding_window_size': WINDOW,
           'sliding_window_stride': WINDOW, 'tta_mode': 1,
           'patch_chunk': PATCH_CHUNK}
NCCL_STEPS = 8                   # phase 31: timed steps of each version


def dist_inputs():
    """Phase 30's inputs: the full-width net's random weights (dropout
    on), the global batch of the flagship step (4 + 4 crops) with the
    seeds of its two domain forwards' dropout generators, and the
    inference volumes."""
    from fpl_plus_torch.models.registry import create_network
    net = create_network(NET_CFG)
    init_random_(net, SEED + 30)
    gen = torch.Generator().manual_seed(SEED + 31)
    batches = [{k: v for k, v in train_inputs(gen, TRAIN_BATCH,
                                              'cpu').items()}
               for _ in range(2)]
    rs = np.random.RandomState(SEED + 32)
    volumes = rs.normal(0.0, 1.0, size=(N_VOLUMES, 1) + VOLUME).astype(
        np.float32)
    volumes[:, :, 12:28, 60:100, 100:170] += 1.5
    return {'net': dict(NET_CFG), 'state': net.state_dict(),
            'batches': batches, 'seeds': [SEED + 33, SEED + 34],
            'volumes': volumes, 'sw': dict(DIST_SW),
            'pass_seeds': DIST_PASS_SEEDS, 'margins': DIST_MARGINS}


def sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize()


def dist_step(inputs, dev, mesh=None):
    """One flagship joint step (Adam, ``train_fpl_uda``, the network's
    dropout from the seeded generators) with TF32 off: on the global batch,
    or over ``mesh`` on this rank's rows. Returns the metrics, gradients
    and state on the CPU, and the step's host seconds."""
    from fpl_plus_torch.models.registry import create_network
    from fpl_plus_torch.parallel import (make_sharded_train_step, replicate,
                                         shard_batch)
    net = create_network(inputs['net'])
    net.load_state_dict(inputs['state'])
    net = net.to(dev)
    step = make_step(net)
    batches = inputs['batches']
    if mesh is not None:
        replicate(net, mesh)
        step = make_sharded_train_step(step, mesh)
        batches = shard_batch(batches, mesh)
    gens = [[torch.Generator(dev).manual_seed(s)] for s in inputs['seeds']]
    with tf32_off():
        t0 = time.perf_counter()
        metrics = step([{k: v.to(dev) for k, v in b.items()}
                        for b in batches], gens)
        sync(dev)
        seconds = time.perf_counter() - t0
    return {'metrics': {k: v.detach().cpu() for k, v in metrics.items()},
            'grads': {k: p.grad.detach().cpu()
                      for k, p in net.named_parameters()},
            'state': {k: v.detach().cpu().clone()
                      for k, v in net.state_dict().items()},
            'step_s': seconds}


def dist_infer(inputs, dev, mesh=None):
    """Phase 30's inference with TF32 off, over ``mesh`` when given: the
    first volume with 4-flip TTA (logits and labels), ``run_batch`` of all
    three (labels), the 6 dropout passes of the first (logits) and their
    FPL reduction. Returns the results, the kernel launches and the host
    seconds of each call."""
    from fpl_plus_torch.agents.agent_seg import head_predictor
    from fpl_plus_torch.engine.infer import Inferer, PassFold
    from fpl_plus_torch.models.registry import create_network
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    net = create_network(inputs['net'])
    net.load_state_dict(inputs['state'])
    predict = head_predictor(net.to(dev).eval(), DOMAIN)
    logits_inf = Inferer(dict(inputs['sw'], output_mode='logits'), dev,
                         mesh=mesh)
    label_inf = Inferer(dict(inputs['sw'], output_mode='label'), dev,
                        mesh=mesh)
    volume = inputs['volumes'][:1]
    fold = PassFold(predict, inputs['pass_seeds'], dev)
    passes = len(inputs['pass_seeds'])
    calls = (('run', lambda: logits_inf.run(predict, volume)),
             ('run_batch', lambda: label_inf.run_batch(predict,
                                                       inputs['volumes'])),
             ('run_passes', lambda: logits_inf.run_passes(fold, volume,
                                                          passes)),
             ('fpl', lambda: label_inf.run_fpl_uncertainty(
                 fold, volume, passes, inputs['margins'])()))
    out, seconds = {}, {}
    with tf32_off():
        dsbn_prelu.launches = 0      # the main path's count starts here
        for name, call in calls:
            t0 = time.perf_counter()
            out[name] = call()
            sync(dev)
            seconds[name] = time.perf_counter() - t0
        launches = dsbn_prelu.launches
    return {'infer': out, 'launches': launches, 'infer_s': seconds}


def dist_rank(rank, port, work, device):
    """Rank ``rank`` of phase 30: a gloo group of DIST_RANKS processes on
    ``device`` (cuda:0), the port's Mesh over it; its inputs come from and
    its results go to ``work``."""
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from fpl_plus_torch.parallel.mesh import Mesh
    dev = torch.device(device)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dist.init_process_group('gloo', init_method='tcp://localhost:{0}'.format(
        port), world_size=DIST_RANKS, rank=rank)
    try:
        mesh = Mesh(dist.group.WORLD, dev)
        inputs = torch.load(os.path.join(work, 'inputs.pt'),
                            weights_only=False)
        out = dict(dist_step(inputs, dev, mesh), **dist_infer(inputs, dev,
                                                              mesh))
        if rank:                  # the other rank's state only: replicas
            out = {'state': out['state'], 'launches': out['launches']}
        torch.save(out, os.path.join(work, 'rank{0}.pt'.format(rank)))
    finally:
        dist.destroy_process_group()


def compare_steps(got, want, lr=1e-4):
    """Phase 11's tolerances on loss, class dice, gradients and running
    statistics; the parameters after the (first) Adam update equal where
    the gradient is above its tolerance (Adam moves every such parameter
    by the rate times its sign), and may differ by up to twice the rate
    only where the gradient is within it (a sign at the noise level).
    Returns the errors; raises on a miss."""
    loss_err = abs(float(got['metrics']['loss'])
                   - float(want['metrics']['loss']))
    dice_err = max(float((got['metrics'][k] - want['metrics'][k]).abs().max())
                   for k in ('class_dice_0', 'class_dice_1'))
    grads = want['grads']
    top = max(float(g.abs().max()) for g in grads.values())
    worst, worst_name, flips = 0.0, None, 0
    for name, g in grads.items():
        tol = GRAD_RTOL * float(g.abs().max()) + GRAD_NET_TOL * top
        err = float((got['grads'][name] - g).abs().max())
        if err / tol > worst:
            worst, worst_name = err / tol, name
        moved = (got['state'][name] - want['state'][name]).abs()
        check(float(moved.max()) <= 2 * lr * (1 + 1e-3),
              'parameter {0} off by {1:.3g} after Adam'.format(
                  name, float(moved.max())))
        off = moved > 1e-2 * lr
        check(bool((g.abs()[off] <= tol).all()),
              'parameter {0} moved otherwise where its gradient is above '
              'the tolerance'.format(name))
        flips += int(off.sum())
    stats_err = 0.0
    for name, t in want['state'].items():
        if name.endswith(('running_mean', 'running_var')):
            stats_err = max(stats_err, float(
                (got['state'][name] - t).abs().max() / t.abs().max()))
    check(loss_err <= STEP_LOSS_TOL, 'loss off by {0:.3g}'.format(loss_err))
    check(dice_err <= STEP_DICE_TOL, 'dice off by {0:.3g}'.format(dice_err))
    check(worst <= 1.0, 'gradient {0} at {1:.3g} of its tolerance'.format(
        worst_name, worst))
    check(stats_err <= STATS_TOL, 'running statistics off by {0:.3g}'.format(
        stats_err))
    return {'loss_err': loss_err, 'dice_err': dice_err, 'grad_worst': worst,
            'stats_err': stats_err, 'noise_flips': flips}


def compare_infer(got, want):
    """Phase 6 / 8's tolerances: logits within FWD_TOL x max(1, |logit|),
    labels agreeing on BATCH_AGREE of the voxels, the FPL pair within
    REDUCE_RTOL and max(1, REDUCE_COUNT_TOL x voxels)."""
    errs = {}
    for name in ('run', 'run_passes'):
        a, b = got[name], want[name]
        check(a.shape == b.shape and bool(np.isfinite(a).all()),
              '{0}: shape {1} vs {2}'.format(name, a.shape, b.shape))
        errs[name] = float(np.abs(a - b).max())
        check(errs[name] <= FWD_TOL * max(1.0, float(np.abs(b).max())),
              '{0} logits off by {1:.3g}'.format(name, errs[name]))
    labels = np.argmax(want['run'], 1)
    errs['run_agree'] = float(np.mean(np.argmax(got['run'], 1) == labels))
    errs['batch_agree'] = float(np.mean(got['run_batch']
                                        == want['run_batch']))
    check(got['run_batch'].shape == (N_VOLUMES,) + VOLUME,
          'run_batch shape {0}'.format(got['run_batch'].shape))
    for key in ('run_agree', 'batch_agree'):
        check(errs[key] >= BATCH_AGREE, '{0} {1:.6f}'.format(key, errs[key]))
    (v_got, b_got), (v_want, b_want) = got['fpl'], want['fpl']
    n_sel = int(np.prod([s - a - b for s, a, b in zip(
        VOLUME, *DIST_MARGINS)]))
    check(np.isfinite(v_got) and v_want > 0
          and abs(v_got - v_want) <= REDUCE_RTOL * abs(v_want),
          'vars_sum {0} vs {1}'.format(v_got, v_want))
    check(abs(b_got - b_want) <= max(1, REDUCE_COUNT_TOL * n_sel),
          'boundary {0} vs {1}'.format(b_got, b_want))
    errs['vars_sum'] = (v_got, v_want)
    errs['boundary'] = (b_got, b_want)
    return errs


def scale_out_bytes(n_params):
    """The bytes the scale-out collectives move (reckoned from the shapes,
    f32): per flagship step and per volume."""
    crops = TRAIN_BATCH * int(np.prod(WINDOW))
    chns = NET_CFG['feature_chns']
    # the 18 DSBN layers' channels: two per encoder block and per decoder
    # block (the decoder at the encoder's widths, deepest first)
    layers = [c for c in chns for _ in range(2)] + [
        c for c in chns[-2::-1] for _ in range(2)]
    return {'grad_allreduce': 4 * n_params,
            'logits_gather_per_domain': 4 * crops * NET_CFG['class_num'],
            'targets_gather_per_domain': 4 * crops * (
                NET_CFG['class_num'] + 1) + 4 * TRAIN_BATCH,
            'stats_allreduce_per_step': sum(4 * (2 * c + 1) for c in layers)
            * 2 * 2,
            'stats_allreduces_per_step': len(layers) * 2 * 2,
            'accumulator_per_volume': 4 * TTA_VARIANTS
            * NET_CFG['class_num'] * int(np.prod(VOLUME))}


def scale_out_phase(dev):
    """Phase 30: the partition math at full width, 2 gloo ranks on cuda:0
    against one process on the same card (TF32 off)."""
    import torch.multiprocessing as tmp
    from fpl_plus_torch.engine.infer import window_grid
    from fpl_plus_torch.parallel.multihost import free_local_port
    inputs = dist_inputs()
    want = dict(dist_step(inputs, dev), **dist_infer(inputs, dev))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, 'build')) as work:
        torch.save(inputs, os.path.join(work, 'inputs.pt'))
        t0 = time.perf_counter()
        tmp.start_processes(dist_rank, args=(free_local_port(), work,
                                             str(dev)),
                            nprocs=DIST_RANKS, join=True,
                            start_method='spawn')
        wall = time.perf_counter() - t0
        got = [torch.load(os.path.join(work, 'rank{0}.pt'.format(r)),
                          weights_only=False) for r in range(DIST_RANKS)]
    step = compare_steps(got[0], want)
    for name, t in got[0]['state'].items():
        check(torch.equal(t, got[1]['state'][name]),
              'the ranks disagree on {0}'.format(name))
    infer = compare_infer(got[0]['infer'], want['infer'])
    launches = sum(g['launches'] for g in got)
    fwd = -(-len(window_grid(VOLUME, WINDOW, WINDOW)) // PATCH_CHUNK)
    check(launches > 0 and launches % 18 == 0,
          '{0} kernel launches in the ranks'.format(launches))
    print('scale-out (phase 30, 2 gloo ranks on one card, correctness run, '
          'not scaling): step loss err {0:.3g}, dice err {1:.3g}, gradients '
          'at {2:.3g} of phase 11\'s tolerance, running statistics {3:.3g}, '
          '{4} parameters moved by a noise-level gradient sign; window-'
          'sharded logits err {5:.3g}, label agreement {6:.6f}, volume-'
          'sharded labels {7:.6f}, pass-sharded logits err {8:.3g}, FPL '
          '(vars_sum, boundary) {9} vs one process {10}; {11} kernel launches over the ranks ({12} forwards '
          'per volume unsharded); host seconds: one process step {13:.3f}, '
          'rank 0 step {14:.3f}, one process inference {15}, rank 0 '
          'inference {16}, ranks wall {17:.1f} s'.format(
              step['loss_err'], step['dice_err'], step['grad_worst'],
              step['stats_err'], step['noise_flips'], infer['run'],
              infer['run_agree'], infer['batch_agree'], infer['run_passes'],
              (infer['vars_sum'][0], infer['boundary'][0]),
              (infer['vars_sum'][1], infer['boundary'][1]), launches, fwd,
              want['step_s'],
              got[0]['step_s'],
              {k: round(v, 3) for k, v in want['infer_s'].items()},
              {k: round(v, 3) for k, v in got[0]['infer_s'].items()}, wall))
    return {'launches': launches, 'step': step, 'infer': infer,
            'step_s': {'one': want['step_s'], 'rank0': got[0]['step_s']},
            'infer_s': {'one': want['infer_s'], 'rank0': got[0]['infer_s']},
            'ranks_wall_s': wall}


@contextlib.contextmanager
def fplx_env(port):
    """The ``FPLX_*`` triple of one process on this host."""
    keys = ('FPLX_COORDINATOR', 'FPLX_NUM_PROCESSES', 'FPLX_PROCESS_ID')
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update({'FPLX_COORDINATOR': 'localhost:{0}'.format(port),
                       'FPLX_NUM_PROCESSES': '1', 'FPLX_PROCESS_ID': '0'})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def watching_barriers(seen):
    """Record (tag, backend, world) of every ``multihost.barrier``."""
    import torch.distributed as dist
    from fpl_plus_torch.parallel import multihost
    real = multihost.barrier

    def watch(tag='sync'):
        seen.append((tag, dist.get_backend(), dist.get_world_size()))
        return real(tag)

    multihost.barrier = watch
    try:
        yield seen
    finally:
        multihost.barrier = real


def multihost_cli_phase(root, dev, fwd_per_volume):
    """Phase 31, first half: ``cli train`` with ``[training] multihost =
    True`` and the ``FPLX_*`` triple of one process (an NCCL group of one
    rank), its auto test stage and ``eva_main``."""
    import torch.distributed as dist
    from fpl_plus_torch import cli
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    from fpl_plus_torch.parallel.multihost import free_local_port
    cfg = train_cfg(root, 'mh', ckpt='mh', stop=2,
                    extra='multihost = True\nmesh_devices = 1',
                    evaluation=EVAL_SECTION.format(root=root))
    seen = []
    t0 = time.perf_counter()
    with fplx_env(free_local_port()), watching_barriers(seen), \
            counting_forwards() as forwards:
        dsbn_prelu.launches = 0          # the main path's count starts here
        rc = cli.main(['train', cfg], device=str(dev))
        launches = dsbn_prelu.launches
    wall = time.perf_counter() - t0
    check(rc == 0, 'multihost cli rc {0}'.format(rc))
    backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    check(not dist.is_initialized(), 'the process group outlived the CLI')
    tags = [t for t, _, _ in seen]
    check({'train-ckpt-written', 'pre-ckpt-resolve', 'pre-exit'} <= set(tags)
          and all(b == backend and w == 1 for _, b, w in seen),
          'barriers {0}'.format(seen))
    ckpt_dir = os.path.join(root, 'model', 'mh')
    for name in ('mh_2.pt', 'mh_latest.txt', 'mh_best.txt'):
        check(os.path.isfile(os.path.join(ckpt_dir, name)), name)
    with open(os.path.join(ckpt_dir, 'scalars.jsonl')) as f:
        rows = [(r['tag'], r['step']) for r in map(json.loads, f)]
    check(rows and len(rows) == len(set(rows)), 'scalar rows written twice')
    seg = os.path.join(root, 'out_train_mh', 'mh_target_test')
    labels = [n for n in os.listdir(seg) if n.endswith('.nii.gz')]
    check(len(labels) == N_VOLUMES, 'auto test labels {0}'.format(labels))
    for metric in ('dice', 'assd'):
        vals = [float(r[1]) for r in read_csv(os.path.join(
            seg, 'test_block_{0}_all.csv'.format(metric)))[1:]]
        check(vals and all(np.isfinite(vals)), '{0} {1}'.format(metric,
                                                                vals))
    n_eval = (2 + N_VOLUMES) + N_VOLUMES     # one validation, the test
    check(forwards[0] == n_eval * fwd_per_volume,
          '{0} eval forwards, expected {1}'.format(
              forwards[0], n_eval * fwd_per_volume))
    check(launches == 18 * forwards[0], '{0} launches for {1} forwards'
          .format(launches, forwards[0]))
    print('multihost cli (phase 31, NCCL, 1 rank): rc 0, barriers {0}, {1} '
          'eval forwards, {2} kernel launches, {3} labels, wall {4:.1f} s'
          .format(tags, forwards[0], launches, len(labels), wall))
    return {'launches': launches, 'barriers': tags, 'wall_s': wall}


def nccl_world1_phase(dev):
    """Phase 31, second half: an NCCL group of one rank in this process;
    the sharded step and the sharded Inferer against the plain ones (TF32
    off), then both steps timed (CUDA events, TF32 as PyTorch's default)."""
    import torch.distributed as dist
    from fpl_plus_torch.engine.infer import Inferer
    from fpl_plus_torch.models.registry import create_network
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    from fpl_plus_torch.parallel import (make_mesh, make_sharded_train_step,
                                         multihost)
    inputs = dist_inputs()
    backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    check(multihost.maybe_initialize_distributed(
        {'training': {'multihost': True}}, dev.type,
        coordinator='localhost:{0}'.format(multihost.free_local_port())),
        'no NCCL group formed')
    try:
        check(dist.get_backend() == backend and dist.get_world_size() == 1,
              'group {0} of {1}'.format(dist.get_backend(),
                                        dist.get_world_size()))
        mesh = make_mesh(1, dev)
        step = compare_steps(dist_step(inputs, dev, mesh),
                             dist_step(inputs, dev))
        net = create_network(NET_CFG)
        net.load_state_dict(inputs['state'])
        net = net.to(dev).eval()

        def predict(x):
            return net(x, DOMAIN)

        volume = inputs['volumes'][:1]
        with tf32_off(), torch.no_grad():
            plain = Inferer(dict(DIST_SW, output_mode='logits'), dev).run(
                predict, volume)
            dsbn_prelu.launches = 0      # the main path's count starts here
            sharded = Inferer(dict(DIST_SW, output_mode='logits'), dev,
                              mesh=mesh).run(predict, volume)
            launches = dsbn_prelu.launches
        infer_err = float(np.abs(sharded - plain).max())
        check(infer_err <= FWD_TOL * max(1.0, float(np.abs(plain).max())),
              'world-1 Inferer off by {0:.3g}'.format(infer_err))
        check(launches > 0, 'no kernel launch in the world-1 Inferer')
        del net
        # timed: the flagship step, plain and wrapped, one after the other
        train = create_network(NET_CFG)
        train.load_state_dict(inputs['state'])
        train = train.to(dev)
        plain_step = make_step(train)
        wrapped = make_sharded_train_step(make_step(train), mesh)
        batches = [{k: v.to(dev) for k, v in b.items()}
                   for b in inputs['batches']]
        times = {'plain': [], 'sharded': []}
        for i in range(2 + NCCL_STEPS):
            for name, fn in (('plain', plain_step), ('sharded', wrapped)):
                gens = [[torch.Generator(dev).manual_seed(s + i)]
                        for s in inputs['seeds']]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(batches, gens)
                end.record()
                end.synchronize()
                if i >= 2:
                    times[name].append(start.elapsed_time(end))
    finally:
        multihost.finalize_distributed()
    check(not dist.is_initialized(), 'the NCCL group outlived the phase')
    ms = {k: float(np.median(v)) for k, v in times.items()}
    overhead = ms['sharded'] / ms['plain'] - 1.0
    print('nccl world 1 (phase 31): sharded vs plain step loss err {0:.3g}, '
          'gradients at {1:.3g} of tolerance, statistics {2:.3g}; sharded '
          'Inferer vs plain max abs err {3:.3g}, {4} launches; step median '
          'ms plain {5:.2f} sharded {6:.2f} ({7:+.2%}; {8} steps each after '
          '2, alternating, f32 with TF32, 4+4 crops)'.format(
              step['loss_err'], step['grad_worst'], step['stats_err'],
              infer_err, launches, ms['plain'], ms['sharded'], overhead,
              NCCL_STEPS))
    return {'launches': launches, 'step': step, 'infer_err': infer_err,
            'step_ms': ms, 'overhead': overhead}



# -- phase 32: the paradigm steps over 2 gloo ranks on one card -------------
PARADIGM_DIST = ([('ssl', m) for m in PARADIGMS['ssl'][2]]
                 + [('wsl', m) for m in PARADIGMS['wsl'][2]]
                 + [('nll', m) for m in NLL_METHODS])
PARADIGM_DIST_ROWS = 2           # global rows per stream (1 per rank)
DAST_DIST_STEPS = 3              # DAST's queues of 2 gate from step 3
PARADIGM_LR = 1e-4               # paradigm_config's and nll_config's rate


def to_dev(tree, dev):
    """Tensors of a nested batch to ``dev``; host numbers stay."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: to_dev(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_dev(v, dev) for v in tree)
    return tree


def skewed(batches, hyper, rank):
    """A rank's own host values: USTM's rotation turned by ``rank``,
    DMPLS's ``beta`` moved by ``rank / 4`` (the step takes rank 0's)."""
    if isinstance(batches, tuple) and isinstance(batches[-1], int):
        batches = batches[:-1] + ((batches[-1] + rank) % 4,)
    if 'beta' in hyper:
        hyper = dict(hyper, beta=hyper['beta'] + rank / 4)
    return batches, hyper


@contextlib.contextmanager
def counting_collectives(sink):
    """Bytes of the mesh's gathers (``Mesh.gather_segments``: each the
    all-reduce of the global buffer) and of all its all-reduces."""
    from fpl_plus_torch.parallel.mesh import Mesh
    gather, reduce = Mesh.gather_segments, Mesh.all_reduce

    def gathering(self, t, sizes):
        out = gather(self, t, sizes)
        sink['gathered'] += out.numel() * out.element_size()
        return out

    def reducing(self, t):
        sink['all_reduced'] += t.numel() * t.element_size()
        return reduce(self, t)

    Mesh.gather_segments, Mesh.all_reduce = gathering, reducing
    try:
        yield sink
    finally:
        Mesh.gather_segments, Mesh.all_reduce = gather, reduce


def paradigm_dist_run(kind, method, i, dev, mesh=None):
    """Phase 32's step(s) of one method at full width with TF32 off (the
    network's dropout and the teacher's noise on): on the global batch, or
    over ``mesh`` on this rank's rows (a rank r > 0 skewing its host
    values). The output convolutions are scaled as in phase 21
    (``scale_heads_``). Results on the card: metrics, the first step's
    gradients and statistics, the state, the teacher, the masks, DAST's
    gates, host seconds and peak memory, the collectives' bytes per
    step."""
    from fpl_plus_torch.parallel import (make_sharded_train_step, replicate,
                                         shard_batch)
    gen = torch.Generator().manual_seed(SEED + 340 + i)
    if kind == 'nll':
        cfg = nll_config(method)
        net = nll_net(cfg, method, SEED + 320 + i)
        host = nll_batches(method, gen, 2 * PARADIGM_DIST_ROWS
                           if method == 'DAST' else PARADIGM_DIST_ROWS,
                           WINDOW)
    else:
        cfg = paradigm_config(kind, method)
        net = paradigm_net(cfg, method, SEED + 320 + i)
        host = paradigm_batches(kind, method, gen, PARADIGM_DIST_ROWS,
                                WINDOW, 'cpu')
    scale_heads_(net)                # logits of order 1, as in phase 21
    net = net.to(dev)
    if mesh is not None:
        replicate(net, mesh)        # before the teacher copies the student
    agent, step = (nll_agent(cfg, net, dev) if kind == 'nll'
                   else paradigm_agent(kind, cfg, net, dev))
    if mesh is not None:
        step = make_sharded_train_step(step, mesh)
    steps = DAST_DIST_STEPS if method == 'DAST' else 1
    metrics, gates, seconds, grads = [], [], [], None
    coll = {'gathered': 0, 'all_reduced': 0}
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    with tf32_off(), recorded_masks() as masks, counting_collectives(coll):
        for it in range(PARADIGM_IT, PARADIGM_IT + steps):
            batches = to_dev(host, dev)
            hyper = (agent.training_hyper(it) if kind == 'nll'
                     else paradigm_hyper(agent, method, it))
            if mesh is not None:
                batches = shard_batch(batches, mesh)
                batches, hyper = skewed(batches, hyper, mesh.rank)
            sync(dev)
            t0 = time.perf_counter()
            m = step(batches, agent._step_generators(it), **hyper)
            sync(dev)
            seconds.append(time.perf_counter() - t0)
            metrics.append({k: v.detach().clone() for k, v in m.items()})
            gates.append(dict(agent.gates) if getattr(agent, 'gates', None)
                         else None)
            if grads is None:
                grads = {k: p.grad.detach().clone()
                         for k, p in net.named_parameters()}
                stats = {k: b.detach().clone()
                         for k, b in net.named_buffers()
                         if k.endswith(('running_mean', 'running_var'))}
    return {'metrics': metrics, 'grads': grads, 'gates': gates,
            'stats': stats,
            'state': {k: v.detach().clone()
                      for k, v in net.state_dict().items()},
            'teacher': None if agent.teacher is None else {
                k: v.clone() for k, v in agent.teacher.params.items()},
            'masks': masks, 'seconds': seconds, 'steps': steps,
            'peak_gib': (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == 'cuda' else None),
            'bytes_per_step': {k: v / steps for k, v in coll.items()}}


def compare_paradigm(got, want, alpha=None):
    """Rank 0's steps against the one-process steps: the first step's loss
    components and dice, its gradients and the statistics after it by phase
    11's tolerances; the parameters after Adam within twice the rate per
    update, and after one update equal wherever the gradient is above its
    tolerance; the teacher within its share of that; the masks equal but
    at a tie of the keep cutoff (MASK_TIE_TOL); the gates equal."""
    m_got, m_want = got['metrics'][0], want['metrics'][0]
    keys = [k for k in m_want if not k.startswith('class_dice')]
    loss_err = max(abs(float(m_got[k]) - float(m_want[k])) for k in keys)
    dice_err = float((m_got['class_dice_0']
                      - m_want['class_dice_0']).abs().max())
    top = max(float(g.abs().max()) for g in want['grads'].values())
    worst, worst_name, flips = 0.0, None, 0
    updates = want['steps']
    for name, g in want['grads'].items():
        tol = GRAD_RTOL * float(g.abs().max()) + GRAD_NET_TOL * top
        err = float((got['grads'][name] - g).abs().max())
        if err / tol > worst:
            worst, worst_name = err / tol, name
        moved = (got['state'][name] - want['state'][name]).abs()
        check(float(moved.max()) <= updates * 2 * PARADIGM_LR * (1 + 1e-3),
              'parameter {0} off by {1:.3g} after Adam'.format(
                  name, float(moved.max())))
        off = moved > 1e-2 * PARADIGM_LR
        if updates == 1:
            check(bool((g.abs()[off] <= tol).all()),
                  'parameter {0} moved otherwise where its gradient is '
                  'above the tolerance'.format(name))
        flips += int(off.sum())
    stats_err = max(float((got['stats'][name] - t).abs().max()
                          / t.abs().max()) for name, t in want['stats'].items())
    teacher_err = None
    if want['teacher'] is not None:
        teacher_err = max(float((got['teacher'][k] - t).abs().max())
                          for k, t in want['teacher'].items())
        check(teacher_err <= (1 - alpha) * 2 * PARADIGM_LR * (1 + 1e-3),
              'teacher off by {0:.3g}'.format(teacher_err))
    check(len(got['masks']) == len(want['masks']), '{0} vs {1} masks'.format(
        len(got['masks']), len(want['masks'])))
    mask_diff = [masks_agree(a, b) for a, b in zip(got['masks'],
                                                   want['masks'])]
    check(all(d == 0 or t for d, t in mask_diff),
          'masks disagree off the cutoff: {0}'.format(mask_diff))
    check(got['gates'] == want['gates'], 'gates {0} vs {1}'.format(
        got['gates'], want['gates']))
    check(loss_err <= STEP_LOSS_TOL, 'loss off by {0:.3g}'.format(loss_err))
    check(dice_err <= STEP_DICE_TOL, 'dice off by {0:.3g}'.format(dice_err))
    check(worst <= 1.0, 'gradient {0} at {1:.3g} of its tolerance'.format(
        worst_name, worst))
    check(stats_err <= STATS_TOL, 'running statistics off by {0:.3g}'.format(
        stats_err))
    return {'loss_err': loss_err, 'dice_err': dice_err, 'grad_worst': worst,
            'stats_err': stats_err, 'teacher_err': teacher_err,
            'noise_flips': flips, 'mask_diff': [d for d, _ in mask_diff],
            'gates': want['gates']}


def replica_gap(tensors, mesh):
    """The largest |x - x on rank 0| of ``tensors`` over the ranks (a
    broadcast of rank 0's values, an all-reduce of the ranks' gaps)."""
    if not tensors:
        return 0.0
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    ref = mesh.broadcast(flat.clone())
    return float(mesh.all_reduce((flat - ref).abs().max().reshape(1))
                 .item())


def paradigm_dist_rank(rank, port, work, device):
    """Rank ``rank`` of phase 32 (a gloo group of DIST_RANKS on
    ``device``): each method's sharded step(s); rank 0 first runs the
    one-process step(s) and holds its rows against them; the ranks'
    states, teachers, masks and gates are compared across the ranks.
    The ranks take the calling process's shapes from ``work``; rank 0
    writes the results there."""
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    from fpl_plus_torch.parallel.mesh import Mesh
    globals().update(torch.load(os.path.join(work, 'shapes.pt'),
                                weights_only=False))
    dev = torch.device(device)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dist.init_process_group('gloo', init_method='tcp://localhost:{0}'.format(
        port), world_size=DIST_RANKS, rank=rank)
    try:
        mesh = Mesh(dist.group.WORLD, dev)
        dsbn_prelu.launches = 0
        results = {}
        for i, (kind, method) in enumerate(PARADIGM_DIST):
            want = (paradigm_dist_run(kind, method, i, dev) if rank == 0
                    else None)
            if dev.type == 'cuda':
                torch.cuda.empty_cache()
            got = paradigm_dist_run(kind, method, i, dev, mesh)
            gaps = {
                'state': replica_gap(list(got['state'].values()), mesh),
                'teacher': replica_gap(list((got['teacher'] or {}).values()),
                                       mesh),
                'masks': replica_gap([m for _, _, m in got['masks']], mesh),
                'gates': replica_gap([torch.tensor(
                    [g['dbc'], g['st']] if g else [-1.0, -1.0])
                    for g in got['gates']], mesh)}
            if rank == 0:
                alpha = None
                if want['teacher'] is not None:
                    alpha = min(1 - 1 / 101, 0.99)   # iter_max 100
                try:
                    cmp = compare_paradigm(got, want, alpha)
                    error = None
                except RuntimeError as exc:
                    cmp, error = None, str(exc)
                results['{0} {1}'.format(kind, method)] = {
                    'compare': cmp, 'error': error, 'gaps': gaps,
                    'one_s': want['seconds'], 'rank0_s': got['seconds'],
                    'one_peak_gib': want['peak_gib'],
                    'rank0_peak_gib': got['peak_gib'],
                    'bytes_per_step': got['bytes_per_step'],
                    'steps': got['steps']}
            del want, got
            if dev.type == 'cuda':
                torch.cuda.empty_cache()
        if rank == 0:
            results['launches'] = dsbn_prelu.launches
            torch.save(results, os.path.join(work, 'paradigm.pt'))
    finally:
        dist.destroy_process_group()


def paradigm_dist_phase(dev):
    """Phase 32: the 15 SSL, WSL and NLL methods at full width, 2 gloo
    ranks on cuda:0 against one process on the same card (TF32 off)."""
    import torch.multiprocessing as tmp
    from fpl_plus_torch.parallel.multihost import free_local_port
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, 'build')) as work:
        torch.save({'PARADIGM_NET': PARADIGM_NET, 'ZOO_CFG': ZOO_CFG,
                    'WINDOW': WINDOW}, os.path.join(work, 'shapes.pt'))
        t0 = time.perf_counter()
        tmp.start_processes(paradigm_dist_rank, args=(free_local_port(), work,
                                                      str(dev)),
                            nprocs=DIST_RANKS, join=True,
                            start_method='spawn')
        wall = time.perf_counter() - t0
        results = torch.load(os.path.join(work, 'paradigm.pt'),
                             weights_only=False)
    launches = results.pop('launches')
    for name, r in results.items():
        c = r['compare']
        print('paradigm 2 gloo ranks (phase 32) {0}: {1}; replica gaps '
              '(state, teacher, masks, gates) {2}; host s one process {3} '
              'rank 0 {4}; peak GiB one process {5} rank 0 {6}; '
              'bytes per step gathered {7:.0f} all-reduced {8:.0f}'.format(
                  name, r['error'] if c is None else
                  'loss err {0:.3g}, dice err {1:.3g}, gradients at {2:.3g} '
                  'of tolerance, statistics {3:.3g}, teacher {4}, {5} '
                  'noise-level flips, mask voxels differing {6}, gates {7}'
                  .format(c['loss_err'], c['dice_err'], c['grad_worst'],
                          c['stats_err'], c['teacher_err'],
                          c['noise_flips'], c['mask_diff'], c['gates']),
                  {k: v for k, v in r['gaps'].items()},
                  ['{0:.3f}'.format(t) for t in r['one_s']],
                  ['{0:.3f}'.format(t) for t in r['rank0_s']],
                  r['one_peak_gib'], r['rank0_peak_gib'],
                  r['bytes_per_step']['gathered'],
                  r['bytes_per_step']['all_reduced']))
    for name, r in results.items():
        check(r['error'] is None, 'phase 32 {0}: {1}'.format(name,
                                                             r['error']))
        check(all(g == 0.0 for g in r['gaps'].values()),
              'phase 32 {0}: the ranks disagree {1}'.format(name, r['gaps']))
    check(launches == 0, 'the paradigm steps launched the kernel {0} '
          'times'.format(launches))
    print('paradigm 2 gloo ranks (phase 32): {0} methods, ranks wall {1:.1f} '
          's'.format(len(results), wall))
    return {'methods': results, 'wall_s': wall}


# -- phase 33: the paradigm and CLSLSR CLIs through NCCL at one rank --------
def fplx_cfg(cfg):
    """A copy of a run's config whose [training] asks for the multihost
    path at a mesh of one (``multihost = True``, ``mesh_devices = 1``)."""
    with open(cfg) as f:
        text = f.read()
    check('random_seed = 3\n' in text, 'no [training] random_seed in ' + cfg)
    out = cfg.replace('.cfg', '_fplx.cfg')
    with open(out, 'w') as f:
        f.write(text.replace('random_seed = 3\n', 'random_seed = 3\n'
                             'multihost = True\nmesh_devices = 1\n'))
    return out


def read_maps(root, csv_name):
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    rows = list(csv.reader(open(os.path.join(root, csv_name))))[1:]
    return [load_image_as_nd_array(os.path.join(
        root, 'slsr_conf', os.path.basename(label)))['data_array']
        for _, label in rows]


def paradigm_nccl_phase(root, dev, fwd_per_volume):
    """Phase 33: ``main_ssl`` (MeanTeacher, with ``eva_main``),
    ``main_wsl`` (GatedCRF on scribbles), ``main_nll`` (DAST, TriNet) for 2
    iterations each with one validation and the auto test stage, and
    ``main_nll_clslsr``, each with the ``FPLX_*`` triple of one process: an
    NCCL group of one rank, its barriers, the mesh's steps and Inferer;
    launches equal to 18 x the UNet2D5 eval forwards (36 per BiNet
    forward, 54 per TriNet forward); the CLSLSR maps against phase 25's."""
    import torch.distributed as dist
    from fpl_plus_torch import cli
    from fpl_plus_torch.agents.nll import DASTStep, TriNetStep
    from fpl_plus_torch.agents.ssl import MeanTeacherStep
    from fpl_plus_torch.agents.wsl import RegularizedStep
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    from fpl_plus_torch.parallel.multihost import free_local_port
    before_maps = read_maps(root, 'd1_train.csv')     # phase 25's
    runs = {
        # tag: (main, stage, cfg, train steps, validations, peers, step)
        'mt_nccl': (cli.main_ssl, 'train', paradigm_cli_cfg(
            root, 'ssl', 'MeanTeacher', 'mt_nccl',
            evaluation=EVAL_SECTION.format(root=root)), 2, 1, 1,
            MeanTeacherStep),
        'crf_nccl': (cli.main_wsl, 'train', paradigm_cli_cfg(
            root, 'wsl', 'GatedCRF', 'crf_nccl',
            train_csv='scribble_train.csv',
            label_transform='PartialLabelToProbability'), 2, 1, 1,
            RegularizedStep),
        'dast_nccl': (cli.main_nll, 'train', nll_cli_cfg(
            root, 'dast_nccl', 'DAST', 2, train_csv='d1_train.csv'), 2, 1,
            2, DASTStep),
        'tri_nccl': (cli.main_nll, 'train', nll_cli_cfg(
            root, 'tri_nccl', 'TriNet', 2), 2, 1, 3, TriNetStep),
        'clslsr_nccl': (cli.main_nll_clslsr, 'test', nll_cli_cfg(
            root, 'clslsr_nccl', train_csv='d1_train.csv', clslsr=True), 0,
            0, 1, None),
    }
    backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    results = {}
    for tag, (main, stage, cfg, steps, validations, peers, step_cls) in \
            runs.items():
        cfg = fplx_cfg(cfg)
        seen, step_ms, valid_ms = [], [], []
        with contextlib.ExitStack() as stack:
            if step_cls is not None:
                stack.enter_context(timed_method(step_cls, '__call__',
                                                 step_ms))
            stack.enter_context(fplx_env(free_local_port()))
            stack.enter_context(watching_barriers(seen))
            forwards = stack.enter_context(counting_forwards())
            torch.cuda.reset_peak_memory_stats()
            dsbn_prelu.launches = 0      # this path's count starts here
            t0 = time.perf_counter()
            rc = main([stage, cfg], device=str(dev))
            wall = time.perf_counter() - t0
            launches = dsbn_prelu.launches
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(rc == 0, 'phase 33 {0} rc {1}'.format(tag, rc))
        check(not dist.is_initialized(), 'the group outlived ' + tag)
        tags = [t for t, _, _ in seen]
        wanted = ({'clslsr-written', 'pre-exit'} if stage == 'test' else
                  {'train-ckpt-written', 'pre-ckpt-resolve', 'pre-exit'})
        check(wanted <= set(tags) and all(b == backend and w == 1
                                          for _, b, w in seen),
              '{0} barriers {1}'.format(tag, seen))
        check(len(step_ms) == steps, '{0}: {1} steps'.format(tag,
                                                             len(step_ms)))
        n_eval = (validations + 1) * N_VOLUMES * fwd_per_volume * peers
        check(forwards[0] == n_eval and launches == 18 * forwards[0],
              '{0}: {1} eval forwards (expected {2}), {3} launches'.format(
                  tag, forwards[0], n_eval, launches))
        extra = ''
        if stage == 'train':
            labels = [n for n in os.listdir(os.path.join(
                root, 'out_' + tag, tag + '_target_test'))
                if n.endswith('.nii.gz')]
            check(len(labels) == N_VOLUMES, '{0} labels {1}'.format(
                tag, labels))
        else:
            agree = [float(np.mean(a == b)) for a, b in zip(
                read_maps(root, 'd1_train.csv'), before_maps)]
            check(len(agree) == N_VOLUMES and min(agree) >= BATCH_AGREE,
                  'CLSLSR maps against phase 25: {0}'.format(agree))
            extra = '; maps agree with phase 25 on {0}'.format(agree)
        results[tag] = {'launches': launches, 'forwards': forwards[0],
                        'step_ms': step_ms, 'wall_s': wall,
                        'peak_gib': peak, 'barriers': tags}
        print('paradigm nccl (phase 33, NCCL, 1 rank) {0} ({1} {2}): rc 0, '
              'barriers {3}, {4} steps at {5} ms, {6} eval forwards, {7} '
              'kernel launches, peak {8:.2f} GiB, {9:.1f} s wall{10}'.format(
                  tag, main.__name__, stage, tags, len(step_ms),
                  ['{0:.1f}'.format(t) for t in step_ms], forwards[0],
                  launches, peak, wall, extra))
    return results


# -- phase 34: [training] / [testing] profile_dir under torch.profiler ------
PROFILE_REPS = 3                 # traced_device_ms repetitions of Inferer.run
PROFILE_STEPS = 6                # phase 12's step: each turn's step count
KERNEL_EVENT = 'dsbn_prelu_kernel'   # the Triton kernel's name in a trace


def one_trace(trace_dir):
    files = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
    check(len(files) == 1 and files[0].endswith('.pt.trace.json.gz'),
          'trace files in {0}: {1}'.format(trace_dir, files))
    return os.path.join(trace_dir, files[0])


def kernel_events(events):
    return sum(1 for e in events if e.get('ph') == 'X'
               and e.get('cat') == 'kernel' and KERNEL_EVENT in e['name'])


def timed_steps(step, batches, gens, n, sink):
    """``n`` calls of ``step`` on ``batches``, each timed by CUDA events
    into ``sink``, as phase 12 times them."""
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(batches, [[gens[0]], [gens[1]]])
        end.record()
        end.synchronize()
        sink.append(start.elapsed_time(end))


def profile_phase(root, dev, serving, names, timed, train, fwd_per_volume):
    """(34) ``[training]`` and ``[testing] profile_dir`` at full width on
    phase 13's workspace: the generator's ``cli train`` (4 iterations, a
    validation every 2, items in the main process) traces its first 2
    steps and no validation; the f32 ``cli test`` of the phase-4 volumes
    traces its volume loop, with labels equal to phase 4's; then
    ``traced_device_ms`` of one ``Inferer.run``, and phase 12's f32 step
    without, with and again without the profiler (CUPTI's cost)."""
    import fpl_plus_torch.agents.agent_seg as agent_seg
    from fpl_plus_torch import cli
    from fpl_plus_torch.engine.infer import Inferer
    from fpl_plus_torch.engine.train import JointTrainStep
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    from fpl_plus_torch.models.registry import create_network
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    from fpl_plus_torch.utils import trace_metrics as tm
    t_phase = time.perf_counter()
    out = {}

    train_dir = os.path.join(root, 'trace_train')
    cfg = train_cfg(root, 'profile', start=0, stop=4, ckpt='profile',
                    extra='profile_dir = ' + train_dir)
    step_ms, stop_s = [], []
    with timed_method(JointTrainStep, '__call__', step_ms), \
            timed_function(agent_seg, 'stop_trace', stop_s), \
            counting_forwards() as forwards:
        dsbn_prelu.launches = 0          # the main path's count starts here
        rc = cli.main(['train', cfg])
        launches = dsbn_prelu.launches
    check(rc == 0, 'profiled train stage rc {0}'.format(rc))
    n_eval = (2 + N_VOLUMES) * 4 // 2 + N_VOLUMES
    check(forwards[0] == n_eval * fwd_per_volume and
          launches == 18 * forwards[0],
          '{0} kernel launches for {1} eval forwards, expected {2}'.format(
              launches, forwards[0], n_eval * fwd_per_volume))
    check(len(step_ms) == 4 and len(stop_s) == 1,
          '{0} steps, {1} trace stops'.format(len(step_ms), len(stop_s)))
    path = one_trace(train_dir)
    events = tm.trace_events(path)
    spans = tm.module_events_us(path)
    host = [e['name'] for e in events
            if e.get('ph') == 'X' and e.get('cat') == tm.HOST_LANE]
    # torch's own ranges (Optimizer.step#Adam.step, ...) may sit inside
    check(len(spans.get('train_step', [])) == 2 and not [
        k for k in spans if k == 'validation_forward'
        or k.startswith('infer_')], 'train trace device spans {0}'.format(
            {k: len(v) for k, v in spans.items()}))
    check(host.count('train_step') == 2 and 'validation_forward' not in host,
          'train trace host spans {0}'.format(sorted(set(host))))
    check(kernel_events(events) == 0, 'the train trace holds {0} DSBN+PReLU '
          'kernels'.format(kernel_events(events)))
    out['train'] = {
        'launches': launches, 'span_us': spans['train_step'],
        'busy_us': tm.device_busy_us(path),
        'kernel_busy_us': tm.kernel_busy_us(path),
        'bytes': os.path.getsize(path), 'events': len(events),
        'step_ms': step_ms, 'stop_s': stop_s[0]}

    test_dir = os.path.join(root, 'trace_test')
    cfg = write_cfg(root, 'profile_test', extra='profile_dir = ' + test_dir)
    vol_ms, stop_s = [], []
    with timed_dispatch(Inferer, 'run_async', vol_ms), \
            timed_function(agent_seg, 'stop_trace', stop_s), \
            counting_forwards() as forwards:
        dsbn_prelu.launches = 0          # the main path's count starts here
        rc = cli.main(['test', cfg])
        launches = dsbn_prelu.launches
    check(rc == 0, 'profiled test stage rc {0}'.format(rc))
    check(forwards[0] == N_VOLUMES * fwd_per_volume
          and launches == 18 * forwards[0],
          '{0} kernel launches for {1} forwards'.format(launches,
                                                        forwards[0]))
    path = one_trace(test_dir)
    events = tm.trace_events(path)
    spans = tm.module_events_us(path)
    check(len(spans.get('infer_run', [])) == N_VOLUMES and not [
        k for k in spans if k in ('train_step', 'validation_forward')],
          'test trace device spans {0}'.format(
              {k: len(v) for k, v in spans.items()}))
    check(kernel_events(events) == launches,
          '{0} DSBN+PReLU kernels in the test trace, {1} launches'.format(
              kernel_events(events), launches))
    same = []
    for name, want in zip(names,
                          serving['float32']['labels']):
        got = load_image_as_nd_array(os.path.join(
            root, 'out_profile_test', 'gen_target_test',
            os.path.basename(name)))['data_array']
        same.append(bool(np.array_equal(got, want)))
    check(all(same), 'profiled labels against phase 4: {0}'.format(same))
    out['test'] = {
        'launches': launches, 'span_us': spans['infer_run'],
        'busy_us': tm.device_busy_us(path),
        'kernel_busy_us': tm.kernel_busy_us(path),
        'bytes': os.path.getsize(path), 'events': len(events),
        'vol_ms': vol_ms, 'stop_s': stop_s[0]}

    # one Inferer.run of a phase-4 volume: the trace's device ms against
    # CUDA events (not counted: a measurement beside the main path)
    # (phase 3's weights, saved by phase 4)
    net = create_network(NET_CFG)
    net.load_state_dict(torch.load(
        os.path.join(root, 'model', 'gen', 'gen_100.pt'),
        map_location='cpu', weights_only=False)['model_state_dict'])
    predictor = agent_seg.head_predictor(
        copy.deepcopy(net).to(dev).eval(), DOMAIN)
    inferer = Inferer({'sliding_window_enable': True,
                       'sliding_window_size': WINDOW,
                       'sliding_window_stride': WINDOW, 'tta_mode': 1,
                       'patch_chunk': PATCH_CHUNK, 'output_mode': 'label'},
                      dev)
    vol = load_image_as_nd_array(os.path.join(root, names[0]))[
        'data_array'].astype(np.float32)
    vol = ((vol - vol.mean()) / vol.std())[None]    # NormalizeWithMeanStd
    run = functools.partial(inferer.run, predictor, vol)
    out['traced_ms'] = tm.traced_device_ms(run, PROFILE_REPS, 'infer_volume')
    out['event_ms'] = cuda_ms(run, reps=PROFILE_REPS)
    check(out['traced_ms'] is not None, 'traced_device_ms found no device '
          'lane on the card')
    from fpl_plus_torch.utils.precision import resolve_dtype
    step = make_step(net.to(dev), resolve_dtype('float32'))
    gen = torch.Generator().manual_seed(SEED + 6)
    batches = [train_inputs(gen, TRAIN_BATCH, dev) for _ in range(2)]
    gens = [torch.Generator(dev).manual_seed(SEED + 340 + i)
            for i in range(2)]
    plain, profiled = [], []
    timed_steps(step, batches, gens, TRAIN_WARMUP, [])
    timed_steps(step, batches, gens, PROFILE_STEPS, plain)
    out['step_traced_ms'] = tm.traced_device_ms(
        functools.partial(timed_steps, step, batches, gens, 1, profiled),
        PROFILE_STEPS, 'train_step')
    timed_steps(step, batches, gens, PROFILE_STEPS, plain)
    out['step_plain_ms'], out['step_profiled_ms'] = plain, profiled
    del step, batches
    torch.cuda.empty_cache()
    out['wall_s'] = time.perf_counter() - t_phase
    t, v = out['train'], out['test']
    unprofiled = float(np.median(t['step_ms'][2:]))
    print('profile (phase 34) train: trace {0} B gzipped ({1} events), 2 '
          'train_step spans on the device lane {2} us (busy {3:.1f} us over '
          'the trace, {4:.1f} us per step; kernels, copies and fills '
          '{5:.1f} us, {6:.2%} of the span union), no validation span, no '
          'DSBN+PReLU kernel; step call (CUDA events) profiled {7} ms, '
          'unprofiled steps 3-4 {8} ms (median {9:.2f}), phase 12 median '
          '{10:.2f} ms, phase 13 {11} ms: profiled step 2 at {12:+.2%} of '
          'steps 3-4, {13:+.2%} of phase 12; stop and write {14:.2f} s; {15} '
          'launches ({16} eval forwards after the trace)'.format(
              t['bytes'], t['events'], ['{0:.1f}'.format(x)
                                        for x in t['span_us']],
              t['busy_us'], t['busy_us'] / 2, t['kernel_busy_us'],
              t['kernel_busy_us'] / t['busy_us'],
              ['{0:.2f}'.format(x) for x in t['step_ms'][:2]],
              ['{0:.2f}'.format(x) for x in t['step_ms'][2:]], unprofiled,
              timed['float32']['ms'],
              ['{0:.1f}'.format(x) for x in train['gen']['step_ms']],
              t['step_ms'][1] / unprofiled - 1,
              t['step_ms'][1] / timed['float32']['ms'] - 1, t['stop_s'],
              t['launches'], t['launches'] // 18))
    print('profile (phase 34) test: trace {0} B gzipped ({1} events), {2} '
          'infer_run spans {3} us (busy {4:.1f} us, {5:.1f} us per volume; '
          'kernels, copies and fills {6:.1f} us, {7:.2%} of it), {8} '
          'DSBN+PReLU kernel events = {9} launches; Inferer.run_async '
          '(CUDA events, dispatch to its copy out, profiled) {10} ms, phase '
          '4 {11} ms; labels equal to phase 4 {12}; stop and write {13:.2f} '
          's'.format(
              v['bytes'], v['events'], N_VOLUMES,
              ['{0:.1f}'.format(x) for x in v['span_us']], v['busy_us'],
              v['busy_us'] / N_VOLUMES, v['kernel_busy_us'],
              v['kernel_busy_us'] / v['busy_us'], v['launches'],
              v['launches'], ['{0:.2f}'.format(x) for x in v['vol_ms']],
              ['{0:.2f}'.format(x) for x in serving['float32']['vol_ms']],
              same, v['stop_s']))
    print('profile (phase 34) Inferer.run of one phase-4 volume: '
          'traced_device_ms {0:.3f} ms per call over {1}, CUDA events '
          '{2:.3f} ms, phase 4 median {3:.2f} ms'.format(
              out['traced_ms'], PROFILE_REPS, out['event_ms'],
              float(np.median(serving['float32']['vol_ms']))))
    p_ms = float(np.median(plain))
    q_ms = float(np.median(profiled))
    print('profile (phase 34) phase 12 f32 step (CUDA events, {0} each): '
          'without the profiler {1} ms (median {2:.2f}), under it {3} ms '
          '(median {4:.2f}, {5:+.2%}; phase 12 median {6:.2f} ms, '
          '{7:+.2%}); traced_device_ms {8:.3f} ms per step; phase wall '
          '{9:.1f} s'.format(
              PROFILE_STEPS, ['{0:.2f}'.format(x) for x in plain], p_ms,
              ['{0:.2f}'.format(x) for x in profiled], q_ms, q_ms / p_ms - 1,
              timed['float32']['ms'], q_ms / timed['float32']['ms'] - 1,
              out['step_traced_ms'], out['wall_s']))
    out['launches'] = t['launches'] + v['launches']
    return out


# -- phase 35: the pipelined test stage --------------------------------------
PIPE_VOLUMES = 8                 # phase 4's 3 volumes and 5 more
PIPE_CSV = 'target_test8.csv'
PIPE_SEED = SEED + 350           # the 5 more volumes
# the peak above the allocation before the stage may exceed phase 4's by one
# volume's outputs: the TTA accumulator of 2 classes over 4 flips in f32
VOLUME_OUT_BYTES = TTA_VARIANTS * 2 * int(np.prod(VOLUME)) * 4
PIPE_MARGINS = ([0, 0, 0], [0, 0, 0])    # Pad's inverse crops nothing here


def serial_infer(self):
    """Phase 35's serial test stage through the same agent (its loader with
    the decode thread, its Inferers, its checkpoint, its saves): each
    volume's ``run`` (or the loader batch's ``run_batch``, or the FPL
    pass's ``run_fpl_uncertainty(...)()``) is fetched, cropped and saved
    before the next is dispatched. Installed as
    ``SegmentationAgent.infer``."""
    import fpl_plus_torch.agents.agent_seg as agent_seg
    from fpl_plus_torch.engine import ckpt as ckpt_lib
    cfg = self.config['testing']
    fpl = cfg.get('fpl', False)
    module = self._loaded_module(ckpt_lib.get_checkpoint_name(self.config))
    label_inf, _ = self._inferers()
    predictor = agent_seg.head_predictor(module, cfg['domian_label'])
    profile_dir = cfg.get('profile_dir')
    if profile_dir:
        agent_seg.start_trace(profile_dir, self.device)
    uncertainty, index = {}, 0
    try:
        for batch in agent_seg.prefetch_iter(self.test_loader):
            samples = list(agent_seg._split_batch(batch))
            if len(samples) > 1 and not fpl:
                labels = label_inf.run_batch(
                    predictor, np.asarray(batch['image'], np.float32))
                for i, data in enumerate(samples):
                    data['predict_label'] = agent_seg._crop(
                        labels[i:i + 1], self._selection_margins(data, 3))
                    self.save_outputs(data)
                index += len(samples)
                continue
            for data in samples:
                image = np.asarray(data['image'], np.float32)
                margins = self._selection_margins(data, 3)
                if fpl:
                    vars_, boundary = label_inf.run_fpl_uncertainty(
                        self._pass_fold(predictor, index, FPL_PASSES),
                        image, FPL_PASSES, margins)()
                    uncertainty[agent_seg._name_of(data)] = [
                        1 if boundary < 50 else vars_ / boundary]
                else:
                    data['predict_label'] = agent_seg._crop(
                        label_inf.run(predictor, image), margins)
                    self.save_outputs(data)
                index += 1
    finally:
        if profile_dir:
            agent_seg.stop_trace()
    if fpl:
        np.save(cfg['fpl_uncertainty_sorted'], np.asarray(sorted(zip(
            uncertainty.values(), uncertainty.keys())), dtype=object))


@contextlib.contextmanager
def host_timeline(sink):
    """Host clock of the stage's volume loop, into lists of ``sink``:
    ``start``, the time of each Inferer dispatch; ``end``, the time each
    volume's work ends (``save_outputs`` returns, or an FPL fetch
    returns); ``dispatch_s``, ``fetch_s`` and ``save_s``, the host seconds
    inside each dispatch, each fetch (its wait for the card) and each
    save. The loop's wall is from the first dispatch to the last end."""
    from fpl_plus_torch.agents.agent_seg import SegmentationAgent
    from fpl_plus_torch.engine.infer import Inferer
    swapped = []

    def swap(cls, name, wrap):
        orig = getattr(cls, name)
        swapped.append((cls, name, orig))
        setattr(cls, name, wrap(orig))

    def dispatch(ends_volume):
        def wrap(orig):
            def inner(self, *args):
                t0 = time.perf_counter()
                sink['start'].append(t0)
                fetch = orig(self, *args)
                sink['dispatch_s'].append(time.perf_counter() - t0)

                def fetched():
                    t1 = time.perf_counter()
                    out = fetch()
                    t2 = time.perf_counter()
                    sink['fetch_s'].append(t2 - t1)
                    if ends_volume:
                        sink['end'].append(t2)
                    return out
                return fetched
            return inner
        return wrap

    def save(orig):
        def inner(self, data):
            t0 = time.perf_counter()
            out = orig(self, data)
            t1 = time.perf_counter()
            sink['save_s'].append(t1 - t0)
            sink['end'].append(t1)
            return out
        return inner

    for name in ('run_async', 'run_batch_async'):
        swap(Inferer, name, dispatch(False))
    swap(Inferer, 'run_fpl_uncertainty', dispatch(True))
    swap(SegmentationAgent, 'save_outputs', save)
    try:
        yield sink
    finally:
        for cls, name, orig in swapped:
            setattr(cls, name, orig)


@contextlib.contextmanager
def agent_loop(loop):
    """``SegmentationAgent.infer`` as it is ('pipelined') or
    ``serial_infer`` ('serial') inside the block."""
    from fpl_plus_torch.agents.agent_seg import SegmentationAgent
    orig = SegmentationAgent.infer
    if loop == 'serial':
        SegmentationAgent.infer = serial_infer
    try:
        yield
    finally:
        SegmentationAgent.infer = orig


def pipeline_phase(root, dev, serving, batched, names, fwd_per_volume):
    """(35) The pipelined test stage on phase 4's workspace with 5 more
    volumes (8 of 40x160x272): the f32 device-label ``cli test`` under
    ``profile_dir``, pipelined and through ``serial_infer``, then both
    without the profiler; ``fpl = True``
    pipelined and serial; ``test_batch_size = 3`` across loader batches;
    then dispatches under ``torch.cuda.set_sync_debug_mode('error')``."""
    import fpl_plus_torch.agents.agent_seg as agent_seg
    from fpl_plus_torch import cli
    from fpl_plus_torch.engine.infer import Inferer, PassFold
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    from fpl_plus_torch.models.registry import create_network
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    from fpl_plus_torch.utils import trace_metrics as tm
    t_phase = time.perf_counter()
    more = write_volumes(root, range(N_VOLUMES, PIPE_VOLUMES),
                         np.random.RandomState(PIPE_SEED))
    all_names = list(names) + more
    write_csv(root, PIPE_CSV, all_names)
    out = {'launches': 0}

    def stage(tag, loop, batch=1, extra='', trace=False):
        trace_dir = os.path.join(root, 'trace_' + tag)
        if trace:
            extra += '\nprofile_dir = ' + trace_dir
        cfg = write_cfg(root, tag, batch=batch, extra=extra, csv=PIPE_CSV)
        times = {k: [] for k in ('start', 'end', 'dispatch_s', 'fetch_s',
                                 'save_s')}
        with agent_loop(loop), host_timeline(times), \
                counting_forwards() as forwards:
            base = start_peak()
            dsbn_prelu.launches = 0      # the main path's count starts here
            rc = cli.main(['test', cfg])
            launches = dsbn_prelu.launches
            peak = torch.cuda.max_memory_allocated() - base
        check(rc == 0, '{0} stage rc {1}'.format(tag, rc))
        n_dispatch = -(-PIPE_VOLUMES // batch)
        want = (n_dispatch if batch > 1 else PIPE_VOLUMES) * fwd_per_volume
        check(forwards[0] == want and launches == 18 * forwards[0],
              '{0}: {1} kernel launches for {2} forwards, expected {3} '
              'forwards'.format(tag, launches, forwards[0], want))
        check(len(times['start']) == (n_dispatch if batch > 1
                                      else PIPE_VOLUMES),
              '{0}: {1} dispatches'.format(tag, len(times['start'])))
        out['launches'] += launches
        r = {'launches': launches, 'peak': peak,
             'wall_s': max(times['end']) - min(times['start'])}
        for k in ('dispatch_s', 'fetch_s', 'save_s'):
            r[k[:-2] + '_ms'] = (float(np.median(times[k])) * 1e3
                                 if times[k] else None)
        if 'fpl = True' not in extra:
            r['labels'] = [load_image_as_nd_array(os.path.join(
                root, 'out_' + tag, 'gen_target_test8',
                os.path.basename(n)))['data_array'] for n in all_names]
        if trace:
            path = one_trace(trace_dir)
            events = tm.trace_events(path)
            spans = tm.module_events_us(path)
            check(len(spans.get('infer_run', [])) == PIPE_VOLUMES,
                  '{0}: infer_run spans {1}'.format(
                      tag, {k: len(v) for k, v in spans.items()}))
            check(kernel_events(events) == launches,
                  '{0}: {1} DSBN+PReLU kernel events, {2} launches'.format(
                      tag, kernel_events(events), launches))
            r['window_us'] = tm.device_window_us(path)
            r['kernel_busy_us'] = tm.kernel_busy_us(path)
            r['idle'] = 1 - r['kernel_busy_us'] / r['window_us']
            r['gaps_us'] = tm.span_gaps_us(path, 'infer_run')
            r['span_us'] = spans['infer_run']
        return r

    label = {loop: stage('pipe_' + loop, loop, trace=True)
             for loop in ('pipelined', 'serial')}
    # the same without the profiler: the wall a user sees
    plain = {loop: stage('plain_' + loop, loop)
             for loop in ('pipelined', 'serial')}
    for i, (a, b, c, d) in enumerate(zip(*(
            r['labels'] for r in (label['pipelined'], label['serial'],
                                  plain['pipelined'], plain['serial'])))):
        check(all(np.array_equal(a, x) for x in (b, c, d)),
              'volume {0}: pipelined and serial labels differ on {1} '
              'voxels'.format(i, int((a != b).sum())))
    for i, want in enumerate(serving['float32']['labels']):
        check(np.array_equal(label['pipelined']['labels'][i], want),
              'volume {0}: pipelined labels differ from phase 4'.format(i))
    limit = serving['float32']['peak'] + VOLUME_OUT_BYTES
    check(label['pipelined']['peak'] <= limit, 'pipelined peak {0} B over '
          'phase 4\'s {1} B and one volume\'s outputs'.format(
              label['pipelined']['peak'], serving['float32']['peak']))

    fpl = {}
    for loop in ('pipelined', 'serial'):
        npy = os.path.join(root, 'fpl8_{0}.npy'.format(loop))
        fpl[loop] = stage('fpl8_' + loop, loop, extra=(
            'fpl = True\nfpl_uncertainty_sorted = ' + npy))
        entries = np.load(npy, allow_pickle=True)
        fpl[loop]['list'] = [(float(np.asarray(e[0]).reshape(-1)[0]),
                              str(e[1])) for e in entries]
    check(fpl['pipelined']['list'] == fpl['serial']['list'],
          'FPL lists differ: pipelined {0}, serial {1}'.format(
              fpl['pipelined']['list'], fpl['serial']['list']))
    check(sorted(n for _, n in fpl['pipelined']['list']) == sorted(all_names)
          and all(np.isfinite(v) for v, _ in fpl['pipelined']['list']),
          'FPL list {0}'.format(fpl['pipelined']['list']))

    batch = stage('batch8', 'pipelined', batch=SERVE_BATCH)
    for i, want in enumerate(batched[0]['labels']):
        check(np.array_equal(batch['labels'][i], want),
              'volume {0}: batched labels differ from phase 8'.format(i))
    agree = [float(np.mean(a == b)) for a, b in zip(
        batch['labels'], label['pipelined']['labels'])]
    check(min(agree) >= BATCH_AGREE_TF32, 'batched labels agree with '
          'per-volume on {0}'.format(agree))

    # dispatches of each async entry with every synchronizing call refused
    net = create_network(NET_CFG)
    net.load_state_dict(torch.load(
        os.path.join(root, 'model', 'gen', 'gen_100.pt'),
        map_location='cpu', weights_only=False)['model_state_dict'])
    predictor = agent_seg.head_predictor(net.to(dev).eval(), DOMAIN)
    inferer = Inferer({'sliding_window_enable': True,
                       'sliding_window_size': WINDOW,
                       'sliding_window_stride': WINDOW, 'tta_mode': 1,
                       'patch_chunk': PATCH_CHUNK, 'output_mode': 'label'},
                      dev)
    vols = np.concatenate([load_image_as_nd_array(os.path.join(root, n))[
        'data_array'].astype(np.float32)[None] for n in all_names[:2]])
    vols = (vols - vols.mean((1, 2, 3, 4), keepdims=True)) / vols.std(
        (1, 2, 3, 4), keepdims=True)
    fold = PassFold(predictor, np.random.SeedSequence(
        [SEED, 35]).generate_state(FPL_PASSES), dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        fetches = [inferer.run_async(predictor, vols[:1]),
                   inferer.run_batch_async(predictor, vols),
                   inferer.run_fpl_uncertainty(fold, vols[:1], FPL_PASSES,
                                               PIPE_MARGINS)]
    finally:
        torch.cuda.set_sync_debug_mode('default')
    one, both, pair = (f() for f in fetches)
    check(np.array_equal(one, inferer.run(predictor, vols[:1])),
          'the fetch of a sync-checked dispatch differs from run')
    check(both.shape == (2,) + VOLUME and np.isfinite(pair[0]),
          'sync-checked batch {0}, FPL pair {1}'.format(both.shape, pair))
    del net, predictor, fold
    torch.cuda.empty_cache()
    out['wall_s'] = time.perf_counter() - t_phase

    for loop, r in label.items():
        q = plain[loop]
        print('pipeline (phase 35) {0} label stage: {1} volumes, wall {2:.4f} '
              's per volume (first dispatch to last save, host clock, under '
              'the profiler), device idle {3:.2%} of the window from the '
              'first to the last kernel ({4:.1f} us, busy {5:.1f} us), '
              'infer_run spans {6} us, gaps between them {7} us (median '
              '{8:.1f}), peak {9:.3f} GiB, {10} launches; host median per '
              'volume: dispatch {11:.2f} ms, fetch wait {12:.2f} ms, save '
              '{13:.2f} ms. Without the profiler: wall {14:.4f} s per '
              'volume; dispatch {15:.2f} ms, fetch wait {16:.2f} ms, save '
              '{17:.2f} ms'.format(
                  loop, PIPE_VOLUMES, r['wall_s'] / PIPE_VOLUMES, r['idle'],
                  r['window_us'], r['kernel_busy_us'],
                  ['{0:.1f}'.format(x) for x in r['span_us']],
                  ['{0:.1f}'.format(x) for x in r['gaps_us']],
                  float(np.median(r['gaps_us'])), r['peak'] / 2 ** 30,
                  r['launches'], r['dispatch_ms'], r['fetch_ms'],
                  r['save_ms'], q['wall_s'] / PIPE_VOLUMES, q['dispatch_ms'],
                  q['fetch_ms'], q['save_ms']))
    print('pipeline (phase 35): labels pipelined = serial on all {0} volumes, '
          '= phase 4 on its {1}; peak pipelined {2:.3f} GiB, serial {3:.3f} '
          'GiB, phase 4 {4:.3f} GiB (limit {5:.3f})'.format(
              PIPE_VOLUMES, N_VOLUMES, label['pipelined']['peak'] / 2 ** 30,
              label['serial']['peak'] / 2 ** 30,
              serving['float32']['peak'] / 2 ** 30, limit / 2 ** 30))
    print('pipeline (phase 35) fpl: wall per volume pipelined {0:.4f} s, '
          'serial {1:.4f} s (first dispatch to last fetch); lists equal; '
          'peak {2:.3f} / {3:.3f} GiB; {4} + {5} launches; host median per '
          'volume, pipelined / serial: dispatch {6:.2f} / {7:.2f} ms, fetch '
          'wait {8:.2f} / {9:.2f} ms'.format(
              fpl['pipelined']['wall_s'] / PIPE_VOLUMES,
              fpl['serial']['wall_s'] / PIPE_VOLUMES,
              fpl['pipelined']['peak'] / 2 ** 30,
              fpl['serial']['peak'] / 2 ** 30, fpl['pipelined']['launches'],
              fpl['serial']['launches'], fpl['pipelined']['dispatch_ms'],
              fpl['serial']['dispatch_ms'], fpl['pipelined']['fetch_ms'],
              fpl['serial']['fetch_ms']))
    print('pipeline (phase 35) test_batch_size {0}: wall per volume {1:.4f} '
          's, labels of the first batch = phase 8, agreement with per-volume '
          '{2}, {3} launches; sync-checked dispatches of run_async, '
          'run_batch_async and run_fpl_uncertainty raised nothing; phase wall '
          '{4:.1f} s'.format(SERVE_BATCH, batch['wall_s'] / PIPE_VOLUMES,
                             ['{0:.5f}'.format(a) for a in agree],
                             batch['launches'], out['wall_s']))
    out.update(label={k: {f: v for f, v in r.items() if f != 'labels'}
                      for k, r in label.items()},
               plain={k: {f: v for f, v in r.items() if f != 'labels'}
                      for k, r in plain.items()},
               fpl={k: {f: v for f, v in r.items() if f != 'list'}
                    for k, r in fpl.items()},
               batch={f: v for f, v in batch.items() if f != 'labels'},
               batch_agree=agree)
    return out


# -- phase 36: the driver entry points and the whole pipeline ---------------
@contextlib.contextmanager
def plain_dsbn():
    """The networks' DSBN+PReLU through ``dsbn_prelu_reference`` (plain
    PyTorch) inside the block."""
    import fpl_plus_torch.models.dsbn as dsbn_module
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu_reference
    real = dsbn_module.dsbn_prelu
    dsbn_module.dsbn_prelu = dsbn_prelu_reference
    try:
        yield
    finally:
        dsbn_module.dsbn_prelu = real


def entry_phase(dev):
    """Phase 36 (a): ``fpl_plus_torch.dryrun.entry()`` on the card: its
    example window gives ``[1, 2, 28, 128, 128]`` logits with 18 kernel
    launches; on a seeded random window (TF32 off) its logits against the
    same module's forward through the plain version, by phase 3's
    tolerance."""
    from fpl_plus_torch import dryrun
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    fn, (x, domain) = dryrun.entry(str(dev))
    check(x.device == dev and tuple(x.shape) == (1, 1) + tuple(WINDOW),
          'entry args {0} on {1}'.format(tuple(x.shape), x.device))
    dsbn_prelu.launches = 0              # the main path's count starts here
    out = fn(x, domain)
    torch.cuda.synchronize()
    launches = dsbn_prelu.launches
    check(tuple(out.shape) == (1, 2) + tuple(WINDOW),
          'entry output {0}'.format(tuple(out.shape)))
    check(launches == 18, 'entry forward launched {0} kernels, not 18'
          .format(launches))
    check(bool(torch.isfinite(out).all()), 'entry logits not finite')
    gen = torch.Generator().manual_seed(SEED + 360)
    probe = torch.randn((1, 1) + tuple(WINDOW), generator=gen).to(dev)
    with tf32_off():
        got = fn(probe, domain).cpu()
        with plain_dsbn():
            want = fn(probe, domain).cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= FWD_TOL * max(1.0, scale),
          'entry forward off its plain version by {0:.3g}'.format(err))
    print('entry (phase 36): output {0}, {1} kernel launches; on a random '
          'window vs the plain version max abs err {2:.3g} (|logit| max '
          '{3:.3g}, tolerance {4} x max(1, |logit|), TF32 off)'.format(
              list(out.shape), launches, err, scale, FWD_TOL))
    return {'launches': launches, 'max_abs_err': err}


def dryrun_phase(dev):
    """Phase 36 (b): the public ``dryrun_multichip(1)`` on the card at the
    JAX dry run's shapes; launches equal to 18 x the eval forwards."""
    from fpl_plus_torch import dryrun
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    t0 = time.perf_counter()
    with counting_forwards() as forwards:
        dsbn_prelu.launches = 0          # the main path's count starts here
        dryrun.dryrun_multichip(1, str(dev))
        launches = dsbn_prelu.launches
    wall = time.perf_counter() - t0
    check(forwards[0] > 0 and launches == 18 * forwards[0],
          'dry run: {0} launches for {1} forwards'.format(launches,
                                                          forwards[0]))
    print('dryrun_multichip(1) (phase 36): {0} eval forwards, {1} kernel '
          'launches, wall {2:.1f} s'.format(forwards[0], launches, wall))
    return {'launches': launches, 'forwards': forwards[0], 'wall_s': wall}


def oracle_cfg(root, name, **kw):
    """A phase-36 config that pins the generator's checkpoint
    (``dryrun_2.pt``) and writes under ``root/oracle``: one process, no
    group."""
    from fpl_plus_torch import dryrun
    path = dryrun.write_cfg(root, name, 1, net_cfg=NET_CFG, window=WINDOW,
                            stride=WINDOW, **kw)
    with open(path) as f:
        text = f.read()
    ckpt = os.path.join(root, 'model', 'dryrun', 'dryrun_2.pt')
    for old, new in (('ckpt_mode = 0', 'ckpt_mode = 2\nckpt_name = ' + ckpt),
                     ('output_dir = {0}/result'.format(root),
                      'output_dir = {0}/oracle'.format(root))):
        check(old in text, 'no {0!r} in {1}'.format(old, path))
        text = text.replace(old, new)
    with open(path, 'w') as f:
        f.write(text)
    return path


def pipeline_labels(path):
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    return {n: load_image_as_nd_array(os.path.join(path, n))['data_array']
            for n in sorted(os.listdir(path)) if n.endswith('.nii.gz')}


def full_pipeline_phase(root, dev, smi):
    """Phase 36 (c): the four stages of ``fpl_plus_torch.dryrun`` at
    NET_CFG (2 cases per domain of 40x160x272; window = stride = crop
    [28,128,128], 4-flip TTA; batch 2 + 2, 2 iterations then resumed to 4,
    a validation every 2) under ``[training] multihost = True`` and the
    ``FPLX_*`` triple of one process: an NCCL group of one rank in each of
    the 4 CLI runs. Stage 2's labels and FPL list against a plain
    one-process ``cli test`` of the generator's checkpoint; launches equal
    to 18 x the eval forwards; each stage's wall; the CLI's evaluation
    CSVs of stages 1 and 4 finite."""
    from fpl_plus_torch import cli, dryrun
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    from fpl_plus_torch.parallel.multihost import free_local_port
    seen = []
    t0 = time.perf_counter()
    with fplx_env(free_local_port()), watching_barriers(seen), \
            counting_forwards() as forwards:
        dsbn_prelu.launches = 0          # the main path's count starts here
        out = dryrun._pipeline(root, 1, dev, NET_CFG, VOLUME, WINDOW, WINDOW,
                               extra_training='multihost = True')
        launches = dsbn_prelu.launches
    wall = time.perf_counter() - t0
    backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    check(seen and all(b == backend and w == 1 for _, b, w in seen),
          'barriers {0}'.format(seen))
    check(forwards[0] > 0 and launches == 18 * forwards[0],
          '{0} launches for {1} eval forwards'.format(launches, forwards[0]))
    for tag in ('pseudo_target', 'final_dir'):
        for metric in ('dice', 'assd'):
            vals = [float(r[1]) for r in read_csv(os.path.join(
                out[tag], 'test_tumor_{0}_all.csv'.format(metric)))[1:]]
            check(vals and all(np.isfinite(vals)),
                  '{0} {1} {2}'.format(tag, metric, vals))
    # the oracle: one plain process, the generator's checkpoint
    unc = os.path.join(root, 'oracle_unc.npy')
    for name, kw in (('oracle_t.cfg', {}),
                     ('oracle_f.cfg', {'test_csv': 'd1cyc_train_img.csv',
                                       'domian': 0}),
                     ('oracle_w.cfg', {'fpl': 'True', 'extra_testing': (
                         'test_time_dropout = True\n'
                         'fpl_uncertainty_sorted = {0}\n'.format(unc))})):
        check(cli.main(['test', oracle_cfg(root, name, **kw)],
                       device=str(dev)) == 0, name)
    voxels = 0
    for sub in ('dryrun_d1_train_img', 'dryrun_d1cyc_train_img'):
        got = pipeline_labels(os.path.join(root, 'result', sub))
        want = pipeline_labels(os.path.join(root, 'oracle', sub))
        check(list(got) == list(want) == ['case0.nii.gz', 'case1.nii.gz'],
              '{0}: {1} vs {2}'.format(sub, list(got), list(want)))
        for n in want:
            check(got[n].shape == (1,) + VOLUME
                  and np.array_equal(got[n], want[n]),
                  '{0}/{1}: labels differ on {2} voxels'.format(
                      sub, n, int((got[n] != want[n]).sum())))
            voxels += got[n].size
    got = np.load(out['uncertainty'], allow_pickle=True)
    want = np.load(unc, allow_pickle=True)
    check([str(e[1]) for e in got] == [str(e[1]) for e in want],
          'FPL list order {0} vs {1}'.format(got[:, 1], want[:, 1]))
    fpl_rel = max(abs(float(a[0][0]) - float(b[0][0]))
                  / max(abs(float(b[0][0])), 1e-30)
                  for a, b in zip(got, want))
    check(fpl_rel <= 1e-5, 'FPL list off by rel {0:.3g}'.format(fpl_rel))
    walls = out['walls']
    for stage in sorted(walls):
        print('pipeline (phase 36) stage {0}: wall {1:.2f} s'.format(
            stage, walls[stage]))
    total = sum(walls.values())
    print('pipeline (phase 36): 4 stages at NET_CFG, {0} cases of {1} per '
          'domain, '
          'NCCL group of one rank per CLI run: {2:.2f} s in all ({3}); {4} '
          'eval forwards, {5} kernel launches; stage-2 labels equal to one '
          'plain process on {6} voxels, FPL list in the same order within '
          'rel {7:.3g}; barriers {8}; phase wall {9:.1f} s'.format(
              dryrun.CASES, list(VOLUME), total, smi, forwards[0],
              launches, voxels, fpl_rel, len(seen), wall))
    return {'launches': launches, 'forwards': forwards[0], 'walls': walls,
            'total_s': total, 'fpl_rel': fpl_rel, 'wall_s': wall}


def driver_phase(root, dev, smi):
    """Phase 36: (a) ``entry()``, (b) ``dryrun_multichip(1)``, (c) the
    full-width pipeline and its oracle."""
    t0 = time.perf_counter()
    entry = entry_phase(dev)
    dry = dryrun_phase(dev)
    os.makedirs(os.path.join(root, 'pipeline36'))
    full = full_pipeline_phase(os.path.join(root, 'pipeline36'), dev, smi)
    wall = time.perf_counter() - t0
    launches = entry['launches'] + dry['launches'] + full['launches']
    print('driver (phase 36): {0} kernel launches, phase wall {1:.1f} s'
          .format(launches, wall))
    return {'entry': entry, 'dryrun': dry, 'full': full,
            'launches': launches, 'wall_s': wall}


PRECISION_STEPS = 2              # phase 37: steps of each method and type
# phase 37, an f16 step against the f32 step from the same weights, batch
# and draws at full width: both round their own way through ~20 layers and
# their batch statistics (the CPU tests measured f16 against f32 within rel
# 8.8e-4 at small widths; JAX's f16 step within 2.1e-5 of the port's)
PRECISION_LOSS_RTOL = 2e-2
MATMUL_VALUES = ('highest', 'default', 'highest')


def precision_steps(dev):
    """(37a) One SSL (MeanTeacher), one WSL (EntropyMinimization), one NLL
    (CoTeaching) and one cls (ResNet18) method for PRECISION_STEPS steps at
    f16 and at f32 from the same weights, batches and draws, on the card:
    the f16 losses finite and within PRECISION_LOSS_RTOL of f32's, the
    parameters and statistics still f32. No kernel launch (train-mode
    forwards only)."""
    from fpl_plus_torch.agents.agent_cls import ClassificationAgent
    from fpl_plus_torch.engine.optim import create_optimizer
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    before = dsbn_prelu.launches

    def paradigm(kind, method, seed):
        def run(precision):
            cfg = (nll_config(method) if kind == 'nll'
                   else paradigm_config(kind, method))
            cfg['training']['precision'] = precision
            if kind == 'nll':
                agent, step = nll_agent(cfg, nll_net(cfg, method, seed), dev)
                batches = batches_to(nll_batches(
                    method, torch.Generator().manual_seed(seed), 4, WINDOW),
                    dev)
            else:
                agent, step = paradigm_agent(
                    kind, cfg, paradigm_net(cfg, method, seed), dev)
                batches = paradigm_batches(
                    kind, method, torch.Generator().manual_seed(seed), 2,
                    WINDOW, dev)
            losses = [float(step(batches, agent._step_generators(k),
                                 **agent.training_hyper(k))['loss'])
                      for k in range(PRECISION_STEPS)]
            return losses, agent.module
        return run

    def cls(seed):
        gen = torch.Generator().manual_seed(seed)
        x = torch.randn((CLS_BATCH, 3, CLS_HW, CLS_HW), generator=gen)
        labels = torch.randint(0, 2, (CLS_BATCH,), generator=gen)

        def run(precision):
            cfg = {'dataset': {'task_type': 'cls'},
                   'network': {'net_type': 'resnet18', 'class_num': 2,
                               'input_chns': 3},
                   'training': {'optimizer': 'Adam', 'learning_rate': 1e-4,
                                'weight_decay': 0.0, 'precision': precision,
                                'loss_type': 'CrossEntropyLoss'},
                   'testing': {}}
            agent = ClassificationAgent(cfg, 'train', dev)
            agent.module = cls_net('resnet18', seed).to(dev).train()
            optimizer = create_optimizer(cfg['training'],
                                         agent.module.parameters())
            loss_calc = agent._loss_calculator()
            losses = [float(agent.train_step(optimizer, loss_calc,
                                             x.to(dev), labels.to(dev),
                                             k)[0])
                      for k in range(PRECISION_STEPS)]
            return losses, agent.module
        return run

    cases = {'ssl MeanTeacher': paradigm('ssl', 'MeanTeacher', SEED + 371),
             'wsl EntropyMinimization': paradigm('wsl', 'EntropyMinimization',
                                                 SEED + 372),
             'nll CoTeaching': paradigm('nll', 'CoTeaching', SEED + 373),
             'cls resnet18': cls(SEED + 374)}
    out = {}
    for tag, run in cases.items():
        got = {}
        for precision in ('float32', 'float16'):
            t0 = time.perf_counter()
            losses, module = run(precision)
            torch.cuda.synchronize()
            check(all(t.dtype in (torch.float32, torch.long)
                      for t in module.state_dict().values()),
                  '{0} {1}: the state left f32'.format(tag, precision))
            got[precision] = (losses, time.perf_counter() - t0)
            del module
            torch.cuda.empty_cache()
        (l32, s32), (l16, s16) = got['float32'], got['float16']
        rel = max(abs(a / b - 1) for a, b in zip(l16, l32))
        out[tag] = {'losses_f32': l32, 'losses_f16': l16, 'rel': rel}
        print('precision {0}: {1} steps at full width, losses f16 {2} '
              'against f32 {3}, within rel {4!r} (tolerance {5}); host '
              'seconds f32 {6:.2f}, f16 {7:.2f} (builds included)'.format(
                  tag, PRECISION_STEPS, l16, l32, rel, PRECISION_LOSS_RTOL,
                  s32, s16))
        check(np.isfinite(l16).all() and rel <= PRECISION_LOSS_RTOL,
              '{0}: f16 losses {1} against f32 {2}'.format(tag, l16, l32))
    check(dsbn_prelu.launches == before, 'the phase 37 steps launched the '
          'DSBN+PReLU kernel')
    return out


def read_conf_maps(root, csv_name):
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    rows = list(csv.reader(open(os.path.join(root, csv_name))))[1:]
    return [load_image_as_nd_array(os.path.join(
        root, 'slsr_conf', os.path.basename(label)))['data_array']
        for _, label in rows]


def clslsr_f16_phase(root, fwd_per_volume):
    """(37b) ``cli nll_clslsr`` of phase 25 over phase 13's train manifest,
    with phase 4's checkpoint (the phase-3 weights: confident learning
    flags voxels with them, and none with phase 13's generator that phase
    25 reads), at ``[testing] precision = float32`` and ``float16`` (its
    ``_loaded_module`` casts the parameters): 18 launches per eval forward
    each, the maps and the manifest as phase 25 checks them, and the f16
    maps against the f32 ones."""
    from fpl_plus_torch import cli
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    out = {}
    for precision in ('float32', 'float16'):
        cfg = nll_cli_cfg(root, 'clslsr_' + precision,
                          train_csv='d1_train.csv', clslsr=True)
        with open(cfg) as f:
            text = f.read()
        with open(cfg, 'w') as f:
            f.write(text.replace('model/train/train_4.pt',
                                 'model/gen/gen_100.pt').replace(
                'cl_type = both', 'cl_type = both\nprecision = ' + precision))
        with counting_forwards() as forwards:
            dsbn_prelu.launches = 0      # the main path's count starts here
            t0 = time.perf_counter()
            rc = cli.main_nll_clslsr(['test', cfg])
            wall = time.perf_counter() - t0
            launches = dsbn_prelu.launches
        check(rc == 0, 'clslsr {0} rc {1}'.format(precision, rc))
        check(forwards[0] == N_VOLUMES * fwd_per_volume
              and launches == 18 * forwards[0], 'clslsr {0}: {1} eval '
              'forwards (expected {2}), {3} launches'.format(
                  precision, forwards[0], N_VOLUMES * fwd_per_volume,
                  launches))
        flagged = check_conf_maps(root, 'd1_train.csv')
        out[precision] = {'launches': launches, 'flagged': flagged,
                          'maps': read_conf_maps(root, 'd1_train.csv'),
                          'wall_s': wall}
    check(sum(out['float32']['flagged']) > 0, 'clslsr f32 flagged no voxel')
    agree = float(np.mean([np.mean(a == b) for a, b in zip(
        out['float32']['maps'], out['float16']['maps'])]))
    print('precision clslsr: phase 4\'s checkpoint, 2 x {0} eval forwards, '
          '{1} kernel launches; voxels flagged per volume f32 {2}, f16 {3}; '
          'the f16 maps agree with f32\'s on {4!r} of voxels; walls {5:.1f} '
          '/ {6:.1f} s'.format(
              forwards[0], sum(r['launches'] for r in out.values()),
              out['float32']['flagged'], out['float16']['flagged'], agree,
              out['float32']['wall_s'], out['float16']['wall_s']))
    return {'launches': sum(r['launches'] for r in out.values()),
            'agree': agree, 'flagged': {p: r['flagged']
                                        for p, r in out.items()},
            'wall_s': {p: r['wall_s'] for p, r in out.items()}}


def matmul_precision_phase(dev):
    """(37c) ``matmul_precision`` highest, default, highest in one process
    (``apply_matmul_precision`` of a stage config each): the two TF32 flags
    after each, and an f32 cuDNN convolution and a matmul under each value,
    bit-equal to the first run under the same value."""
    from fpl_plus_torch.utils.precision import apply_matmul_precision
    gen = torch.Generator().manual_seed(SEED + 375)
    x = torch.randn((BATCH, 32, 28, 64, 64), generator=gen).to(dev)
    w = (torch.randn((32, 32, 1, 3, 3), generator=gen) * 0.1).to(dev)
    a = torch.randn((1024, 1024), generator=gen).to(dev)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    seen, flags = {}, []
    try:
        for value in MATMUL_VALUES:
            apply_matmul_precision({'testing': {'matmul_precision': value}},
                                   'test')
            now = (torch.backends.cudnn.allow_tf32,
                   torch.backends.cuda.matmul.allow_tf32)
            y = (F.conv3d(x, w, padding=(0, 1, 1)), a @ a)
            torch.cuda.synchronize()
            flags.append(now)
            if value in seen:
                check(now == seen[value][0] and all(
                    torch.equal(u, v) for u, v in zip(y, seen[value][1])),
                    'matmul_precision {0} again: flags {1}, results not '
                    'bit-equal'.format(value, now))
            else:
                seen[value] = (now, y)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved
    check(flags == [(False, False), (True, False), (False, False)],
          'matmul_precision flags {0}'.format(flags))
    conv_gap = float((seen['highest'][1][0] - seen['default'][1][0]).abs()
                     .max())
    print('precision matmul_precision {0}: (cudnn, matmul) TF32 flags {1}; '
          'the repeated value bit-equal; conv highest vs default max abs '
          'diff {2!r}'.format(list(MATMUL_VALUES), flags, conv_gap))
    return {'flags': flags, 'conv_gap': conv_gap}


TRACE_PAIRS = 4                  # phase 38: (train step, inference) traces
TRACE_FORWARDS = 6               # phase 38: eval forwards per inference trace


def launch_audit(path):
    """(kernel launch calls after ``start_trace``'s priming ones, those
    whose kernel has no event, the least kernel start less its launch
    call's start in us) of one trace: a launch call (runtime or driver
    API) and its kernel share a correlation id."""
    from fpl_plus_torch.utils import trace_metrics as tm
    events = [e for e in tm.trace_events(path) if e.get('ph') == 'X']
    kernels = {e['args'].get('correlation'): e for e in events
               if e.get('cat') == 'kernel'}
    calls = sorted((e for e in events
                    if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                    and 'LaunchKernel' in e['name']),
                   key=lambda e: float(e['ts']))
    primed = [i for i, e in enumerate(calls) if tm.PRIME_KERNEL in
              kernels.get(e['args'].get('correlation'), {}).get('name', '')]
    calls = calls[primed[-1] + 1 if primed else 0:]
    lost = [e for e in calls if e['args'].get('correlation') not in kernels]
    skew = [float(kernels[e['args']['correlation']]['ts']) - float(e['ts'])
            for e in calls if e['args'].get('correlation') in kernels]
    return len(calls), len(lost), min(skew)


# (tokens, channels, heads, padded grid, window) of each stage of a
# [32, 128, 128] window forward of the benchmark's Swin UNETR
SWIN_CFG = {'net_type': 'SwinUNETR', 'in_chns': 1, 'class_num': 2,
            'feature_size': 48, 'depths': [2, 2, 2, 2],
            'num_heads': [3, 6, 12, 24]}
SWIN_WINDOW = (32, 128, 128)
SWIN_STAGES = ((343, 48, 3, (21, 70, 70), (7, 7, 7)),
               (343, 96, 6, (14, 35, 35), (7, 7, 7)),
               (196, 192, 12, (4, 21, 21), (4, 7, 7)),
               (98, 384, 24, (2, 14, 14), (2, 7, 7)))
SWIN_SOURCE = 'fpl_plus_torch/ops/window_attention.py'
# the kernel against its plain version: f32 -- the same f32 products and
# sums in another order, exp by another instruction; TF32 -- both round
# the operands to 10 mantissa bits, in other orders; bf16 and f16 -- both
# round the probabilities to the input type before PV, so they differ by
# an ulp of a probability where the f32 values straddle a rounding
# boundary, and by one rounding of the output
SWIN_TOL = {'float32': 1e-4, 'tf32': 2e-2, 'bfloat16': 3e-2,
            'float16': 5e-3}
# the network, eval (kernel) against train mode (plain) under no_grad,
# f32 with TF32 off: ~40 layers of the same sums in other orders
SWIN_FWD_TOL = 1e-3
# phase 39's test stage: the benchmark cell's network, window and chunking
SWIN_TEST_CFG = """
[dataset]
task_type = seg
root_dir = {root}
modal_num = 1
test_csv = {root}/target_test.csv
test_batch_size = 1
test_transform = [NormalizeWithMeanStd, Pad]
NormalizeWithMeanStd_channels = [0]
Pad_output_size = [32, 128, 128]

[network]
net_type = SwinUNETR
class_num = 2
in_chns = 1
feature_size = 48
depths = [2, 2, 2, 2]
num_heads = [3, 6, 12, 24]

[training]
ckpt_save_dir = {root}/model/gen

[testing]
ckpt_mode = 0
domian_label = 0
output_dir = {root}/out_swin
sliding_window_enable = True
sliding_window_size = [32, 128, 128]
sliding_window_stride = [32, 128, 128]
tta_mode = 1
patch_chunk = 2
precision = float32
"""


def swin_test_stage(net):
    """Phase 39's main path: the agent's test stage (``cli.main(['test',
    cfg])``: the loader, the sliding window with 4-flip TTA, the label
    save) on Swin UNETR at the published widths and the benchmark's
    [32, 128, 128] window, with the launch counters set to 0 just before
    it. Returns (eval forwards, launches, shifted launches, labels)."""
    from fpl_plus_torch import cli
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    from fpl_plus_torch.models.swin_unetr import SwinUNETR
    from fpl_plus_torch.ops.window_attention import window_attention
    forwards = [0]

    def count(module, args, out):
        if isinstance(module, SwinUNETR) and not module.training:
            forwards[0] += 1

    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, 'build')) as root:
        names = write_volumes(root, range(N_VOLUMES),
                              np.random.RandomState(SEED + 39))
        write_csv(root, 'target_test.csv', names)
        ckpt_dir = os.path.join(root, 'model', 'gen')
        os.makedirs(ckpt_dir)
        torch.save({'iteration': 100, 'valid_pred': 0.0,
                    'model_state_dict': net.state_dict()},
                   os.path.join(ckpt_dir, 'gen_100.pt'))
        with open(os.path.join(ckpt_dir, 'gen_latest.txt'), 'w') as f:
            f.write('100')
        cfg = os.path.join(root, 'swin.cfg')
        with open(cfg, 'w') as f:
            f.write(SWIN_TEST_CFG.format(root=root))
        hook = torch.nn.modules.module.register_module_forward_hook(count)
        try:
            window_attention.launches = 0   # the main path's count
            window_attention.shifted = 0
            rc = cli.main(['test', cfg])
            launches = window_attention.launches
            shifted = window_attention.shifted
        finally:
            hook.remove()
        check(rc == 0, 'Swin UNETR test stage rc {0}'.format(rc))
        labels = [load_image_as_nd_array(os.path.join(
            root, 'out_swin', 'gen_target_test', os.path.basename(name)))[
                'data_array'] for name in names]
    return forwards[0], launches, shifted, labels


def window_attention_phase(dev):
    """Phase 39: the window-attention kernel and Swin UNETR on the card."""
    from fpl_plus_torch.models.registry import create_network
    from fpl_plus_torch.models.swin_unetr import shift_regions
    from fpl_plus_torch.ops.window_attention import (
        relative_position_index, window_attention,
        window_attention_reference)
    peak = {'float32': 6.7e13, 'bfloat16': 9.89e14, 'float16': 9.89e14}
    rate = memory_rate(torch.cuda.get_device_name(dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 39)
    rows, worst = [], {}
    for n, c, heads, dims, win in SWIN_STAGES:
        nw = int(np.prod(dims)) // n
        bw = BATCH * nw
        qkv32 = torch.randn(bw, n, 3 * c, generator=gen, device=dev)
        table32 = torch.randn(13 ** 3, heads, generator=gen, device=dev)
        shift = tuple(0 if w < 7 else 3 for w in win)
        regions = shift_regions(dims, win, shift).to(dev)
        index = relative_position_index((7, 7, 7))[:n, :n].to(dev)
        for precision in ('float32', 'tf32', 'bfloat16', 'float16'):
            dtype = getattr(torch, precision if precision != 'tf32'
                            else 'float32')
            qkv, table = qkv32.to(dtype), table32.to(dtype)
            torch.backends.cuda.matmul.allow_tf32 = precision == 'tf32'
            try:
                for reg in (None, regions):
                    before = (window_attention.launches,
                              window_attention.shifted)
                    with torch.no_grad():
                        got = window_attention(qkv, table, heads, (7, 7, 7),
                                               reg)
                        want = window_attention_reference(
                            qkv, table, heads, (7, 7, 7), reg)
                    torch.cuda.synchronize()
                    check(window_attention.launches == before[0] + 1
                          and window_attention.shifted
                          == before[1] + (reg is not None),
                          'window attention launches not counted')
                    check(got.dtype == dtype and got.shape == (bw, n, c),
                          'window attention output {0} {1}'.format(
                              got.dtype, tuple(got.shape)))
                    err = (got.float() - want.float()).abs().max().item()
                    tol = SWIN_TOL[precision]
                    check(err <= tol, 'window attention disagrees with '
                          'plain at n {0}, {1}, shifted {2}: max abs err '
                          '{3}'.format(n, precision, reg is not None, err))
                    worst[precision] = max(worst.get(precision, 0.0), err)
                    del got, want
                    if precision == 'tf32':
                        continue
                    with torch.no_grad():
                        ms = cuda_ms(lambda: window_attention(
                            qkv, table, heads, (7, 7, 7), reg))
                        plain_ms = cuda_ms(lambda: window_attention_reference(
                            qkv, table, heads, (7, 7, 7), reg), reps=3)
                        q, k, v = qkv.view(BATCH, nw, n, 3, heads,
                                           c // heads).permute(
                            3, 0, 1, 4, 2, 5).unbind(0)
                        mask = table[index.reshape(-1)].reshape(
                            n, n, heads).permute(2, 0, 1)[None]
                        if reg is not None:
                            mask = mask + (-100.0 * (
                                reg[:, :, None] != reg[:, None, :])).to(
                                dtype)[:, None]
                        library_ms = cuda_ms(
                            lambda: F.scaled_dot_product_attention(
                                q, k, v, attn_mask=mask), reps=5)
                        del q, k, v, mask
                    flops = 4.0 * bw * n * n * c
                    nbytes = (4 * bw * n * c + table.numel()) \
                        * qkv.element_size()
                    bound = max(flops / peak[precision], nbytes / rate) * 1e3
                    rows.append({'tokens': n, 'channels': c, 'heads': heads,
                                 'windows': bw, 'dtype': precision,
                                 'shifted': reg is not None, 'ms': ms,
                                 'bound_ms': bound,
                                 'bound_by': ('operations' if flops
                                              / peak[precision] > nbytes
                                              / rate else 'bytes'),
                                 'plain_ms': plain_ms,
                                 'library_ms': library_ms})
                    print('window attention n {0} C {1} heads {2} x {3} '
                          '{4}{5}: {6:.4f} ms, bound {7:.4f} ms ({8:.0%}), '
                          'plain {9:.3f} ms, SDPA {10:.3f} ms, max abs err '
                          '{11:.3g}'.format(
                              n, c, heads, bw, precision,
                              ' shifted' if reg is not None else '', ms,
                              bound, bound / ms, plain_ms, library_ms, err))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        del qkv32, table32, qkv, table
        torch.cuda.empty_cache()
    net = create_network(SWIN_CFG).to(dev)
    pgen = torch.Generator().manual_seed(SEED + 40)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith('relative_position_bias_table'):
                p.copy_(torch.randn(p.shape, generator=pgen))
    x = torch.randn((BATCH, 1) + SWIN_WINDOW, generator=gen, device=dev)
    with tf32_off(), torch.no_grad():
        before = (window_attention.launches, window_attention.shifted)
        got = net.eval()(x)
        launches = window_attention.launches - before[0]
        shifted = window_attention.shifted - before[1]
        want = net.train()(x)
        torch.cuda.synchronize()
        check(window_attention.launches - before[0] == launches,
              'train mode launched the window attention kernel')
    check(launches == 8 and shifted == 4, 'a Swin UNETR forward launched '
          '{0} window attentions ({1} shifted), not 8 (4)'.format(
              launches, shifted))
    check(bool(torch.isfinite(got).all()), 'non-finite Swin UNETR logits')
    fwd_err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print('swin unetr {0} f32 TF32-off: eval (kernel) vs train mode (plain) '
          'max abs err {1:.3g} (|logit| max {2:.3g}); {3} launches, {4} '
          'shifted'.format(list(x.shape), fwd_err, scale, launches, shifted))
    check(fwd_err <= SWIN_FWD_TOL * max(1.0, scale),
          'Swin UNETR eval forward disagrees with the plain attention')
    del got, want
    net.eval()
    from fpl_plus_torch.engine.infer import window_grid
    fwd_per_volume = -(-len(window_grid(VOLUME, SWIN_WINDOW, SWIN_WINDOW))
                       // PATCH_CHUNK)
    forwards, stage_launches, stage_shifted, labels = swin_test_stage(net)
    print('swin unetr test stage: {0} volumes {1}, {2} eval forwards, {3} '
          'window attention launches ({4} shifted)'.format(
              N_VOLUMES, list(VOLUME), forwards, stage_launches,
              stage_shifted))
    check(forwards == N_VOLUMES * fwd_per_volume,
          'Swin UNETR test stage: {0} forwards, expected {1}'.format(
              forwards, N_VOLUMES * fwd_per_volume))
    check(stage_launches == 8 * forwards and stage_shifted == 4 * forwards,
          'Swin UNETR test stage: {0} launches ({1} shifted) for {2} '
          'forwards, not 8 (4) each'.format(stage_launches, stage_shifted,
                                            forwards))
    for lab in labels:
        check(lab.shape == (1,) + VOLUME and lab.dtype == np.uint8
              and set(np.unique(lab).tolist()) <= {0, 1},
              'Swin UNETR label {0} {1}'.format(lab.shape, lab.dtype))
    fwd_ms = {}
    for precision, dtype in (('float32', torch.float32),
                             ('bfloat16', torch.bfloat16)):
        m = copy.deepcopy(net).to(dtype)
        xx = x.to(dtype)
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.no_grad():
            fwd_ms[precision] = cuda_ms(lambda: m(xx), reps=5)
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print('swin unetr forward {0} (cuDNN TF32 as default): {1:.2f} ms, '
              'peak {2:.2f} GiB'.format(precision, fwd_ms[precision],
                                        peak_gib))
        del m, xx
        torch.cuda.empty_cache()
    return {'name': 'window_attention', 'route': 'triton',
            'source': SWIN_SOURCE, 'replaces': None, 'rows': rows,
            'max_abs_err': worst,
            'launches_per_forward': stage_launches / forwards,
            'shifted_per_forward': stage_shifted / forwards,
            'test_stage_forwards': forwards,
            'forward_max_abs_err': fwd_err,
            'forward_ms': fwd_ms}


def trace_sessions_phase(dev, net):
    """(38) Back-to-back ``trace_metrics`` sessions (see the module
    docstring): each trace's launch calls against its kernel events."""
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    from fpl_plus_torch.utils import trace_metrics as tm
    t0 = time.perf_counter()
    batches = train_batches(dev)
    step, draws = phase12_step(dev, net, 'float32')
    gens = draws()
    step(batches, gens)
    eval_net = copy.deepcopy(net).to(dev).eval()
    x = torch.randn((BATCH, 1) + tuple(WINDOW), generator=torch.Generator(
        ).manual_seed(SEED + 9)).to(dev)

    def infer():
        with torch.inference_mode():
            for _ in range(TRACE_FORWARDS):
                eval_net(x, DOMAIN)
    infer()
    torch.cuda.synchronize(dev)
    lost, skews = 0, []
    for i in range(TRACE_PAIRS):
        for tag, fn in (('train', lambda: step(batches, gens)),
                        ('infer', infer)):
            with tempfile.TemporaryDirectory(dir=os.path.join(
                    REPO, 'build')) as trace_dir:
                dsbn_prelu.launches = 0
                tm.start_trace(trace_dir, dev)
                try:
                    fn()
                finally:
                    tm.stop_trace()
                launches = dsbn_prelu.launches
                path = one_trace(trace_dir)
                calls, missing, skew = launch_audit(path)
                events = kernel_events(tm.trace_events(path))
            want = 18 * TRACE_FORWARDS if tag == 'infer' else 0
            print('trace session {0} {1}: {2} launch calls, {3} without a '
                  'kernel event; DSBN+PReLU {4} launches, {5} kernel events; '
                  'least kernel start less its launch call {6!r} us'.format(
                      i, tag, calls, missing, launches, events, skew))
            check(missing == 0 and launches == want and events == launches,
                  'trace session {0} {1}: {2} of {3} launch calls without '
                  'a kernel event, {4} DSBN+PReLU events for {5} '
                  'launches'.format(i, tag, missing, calls, events,
                                    launches))
            lost += missing
            skews.append(skew)
    wall = time.perf_counter() - t0
    print('trace sessions (phase 38): {0} traces, {1} launch calls without '
          'a kernel event, least kernel start less its launch call {2!r} us '
          '(start_trace primes {3} s), phase wall {4:.1f} s'.format(
              len(skews), lost, min(skews), tm.PRIME_S, wall))
    return {'sessions': len(skews), 'lost': lost, 'skew_us': skews,
            'wall_s': wall}


def precision_phase(root, dev, fwd_per_volume):
    """Phase 37: (a) the f16 paradigm and cls steps, (b) the CLSLSR
    inference at f16, (c) ``matmul_precision`` across stages."""
    t0 = time.perf_counter()
    out = {'steps': precision_steps(dev),
           'clslsr': clslsr_f16_phase(root, fwd_per_volume),
           'matmul': matmul_precision_phase(dev)}
    out['wall_s'] = time.perf_counter() - t0
    out['launches'] = out['clslsr']['launches']
    print('precision (phase 37): {0} kernel launches, phase wall {1:.1f} s'
          .format(out['launches'], out['wall_s']))
    return out


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing run', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import fpl_plus_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device('cuda', 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print('device: {0}, torch {1}, CUDA {2}'.format(
        kind, torch.__version__, torch.version.cuda))
    print(smi)
    rate = memory_rate(kind)
    print('memory rate for bounds: {0:.3g} B/s (data sheet)'.format(rate))

    rows, max_err, big, plain_ms, yard_ms = kernel_phase(dev, rate)
    grad_refusal_phase(dev)
    net, macs = forward_phase(dev)
    step_check = train_step_phase(dev)
    timed = timed_train_phase(dev, net, macs)
    os.makedirs(os.path.join(REPO, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, 'build')) as ws:
        serving, names, fwd_per_volume = serving_phase(ws, net)
        rows48, max_err48, big48, plain48, yard48 = kernel_phase(
            dev, rate, FPL_BATCH)
        rows.update(rows48)
        rows24, max_err24 = kernel_phase(dev, rate, SERVE_BATCH * BATCH)[:2]
        rows.update(rows24)
        fold_phase(dev, net)
        fpl = fpl_phase(ws, dev, names, fwd_per_volume)
        batched = batched_phase(ws, serving['float32']['labels'], names,
                                fwd_per_volume)
        tools_phase(ws, fpl)
        train = train_cli_phase(ws, names, fwd_per_volume)
        evaluation = evaluation_phase(ws, train)
        variants = variants_phase(ws, fwd_per_volume)
        variant_check = variant_check_phase(dev)
        paths = test_paths_phase(ws, names, serving, fpl)
        zoo = zoo_phase(dev)
        zoo_train = zoo_train_phase(dev, zoo)
        supervised = supervised_phase(ws, dev)
        ssl_check = paradigm_check('ssl', dev)
        ssl_timed = paradigm_timed('ssl', dev, macs)
        wsl_check = paradigm_check('wsl', dev)
        wsl_timed = paradigm_timed('wsl', dev, macs)
        paradigm_cli = paradigm_cli_phase(ws, fwd_per_volume)
        nll_steps_check = nll_check(dev)
        nll_steps = nll_timed(dev, macs)
        nll_cli = nll_cli_phase(ws, fwd_per_volume)
        cls_steps_check = cls_check(dev)
        cls_steps = cls_timed(dev)
        cls_cli = cls_cli_phase(ws)
        pool = pool_phase(ws, train, fwd_per_volume)
        tools = host_tools_phase(ws, names, fwd_per_volume)
        converter = converter_phase(ws, dev)
        scale_out = scale_out_phase(dev)
        multihost_cli = multihost_cli_phase(ws, dev, fwd_per_volume)
        nccl = nccl_world1_phase(dev)
        paradigm_dist = paradigm_dist_phase(dev)
        paradigm_nccl = paradigm_nccl_phase(ws, dev, fwd_per_volume)
        profile = profile_phase(ws, dev, serving, names, timed, train,
                                fwd_per_volume)
        pipeline = pipeline_phase(ws, dev, serving, batched, names,
                                  fwd_per_volume)
        driver = driver_phase(ws, dev, smi)
        half = precision_phase(ws, dev, fwd_per_volume)
    sessions = trace_sessions_phase(dev, net)
    swin = window_attention_phase(dev)
    bytes_ = scale_out_bytes(sum(p.numel() for p in net.parameters()))
    print('scale-out bytes (reckoned, f32): {0}'.format(bytes_))
    flop_per_volume = 2 * macs * BATCH * fwd_per_volume

    launch_shapes = dsbn_shapes(BATCH)
    per_volume = {}
    for precision, dtype in zip(PRECISIONS, DTYPES):
        fwd = serving[precision]['forwards'] / N_VOLUMES   # measured
        k_ms = fwd * sum(rows[(s, dtype)]['fold_ms'] for s in launch_shapes)
        b_ms = fwd * sum(rows[(s, dtype)]['bound_ms'] for s in launch_shapes)
        v_ms = float(np.median(serving[precision]['vol_ms']))
        per_volume[precision] = (k_ms, b_ms, v_ms)
        print('per volume {0}: Inferer.run_async median {1:.2f} ms; kernel '
              '{2:.3f} '
              'ms ({3:.1%} of it) for {4} launches; kernel bound {5:.3f} ms; '
              'conv {6:.2f} TFLOP per volume, {7:.1f} TFLOP/s over the run'
              .format(precision, v_ms, k_ms, k_ms / v_ms,
                      serving[precision]['launches'] // N_VOLUMES, b_ms,
                      flop_per_volume / 1e12,
                      flop_per_volume / v_ms / 1e9))
    fpl_shapes = dsbn_shapes(FPL_BATCH)
    fpl_flop_per_volume = 2 * macs * FPL_BATCH * fwd_per_volume
    fpl_kernel = {}
    for precision, dtype in zip(PRECISIONS, DTYPES):
        fwd = fpl[precision]['forwards'] / N_VOLUMES       # measured
        k_ms = fwd * sum(rows[(s, dtype)]['fold_ms'] for s in fpl_shapes)
        b_ms = fwd * sum(rows[(s, dtype)]['bound_ms'] for s in fpl_shapes)
        v_ms = float(np.median(fpl[precision]['vol_ms']))
        fpl_kernel[precision] = (k_ms, b_ms)
        print('fpl per volume {0}: run_fpl_uncertainty median {1:.2f} ms; '
              'kernel {2:.3f} ms ({3:.1%} of it) for {4} launches; kernel '
              'bound {5:.3f} ms; peak {6:.2f} GiB; conv {7:.2f} TFLOP per '
              'volume, {8:.1f} TFLOP/s over the pass'.format(
                  precision, v_ms, k_ms, k_ms / v_ms,
                  fpl[precision]['launches'] // N_VOLUMES,
                  b_ms, fpl[precision]['peak'] / 2 ** 30,
                  fpl_flop_per_volume / 1e12,
                  fpl_flop_per_volume / v_ms / 1e9))
    for tag, r in train.items():
        steps = r['step_ms'][1:] or r['step_ms']
        wait = float(np.mean(r['host_wait_s']))
        print('train {0} summary: step call median {1:.2f} ms after the '
              'first; host wait {2:.4f} s per iteration ({3:.1%} of the '
              'step); validation {4:.2f} ms per volume (median over the '
              'validations)'
              .format(tag, float(np.median(steps)), wait,
                      wait / (float(np.median(steps)) / 1e3),
                      float(np.median(r['valid_ms']))))
    for tag, r in variants.items():
        print('variant {0} summary: step {1:.2f} ms (the second step), peak '
              '{2:.2f} GiB, {3} updates'.format(tag, r['step_ms'][-1],
                                                r['peak_gib'], r['updates']))
    for tag, r in zoo.items():
        t = zoo_train.get(tag)
        print('zoo summary {0}: {1:.3f} GMAC per window, eval forward {2:.2f} '
              'ms (8 windows), peak {3:.2f} GiB{4}'.format(
                  tag, r['gmac_per_window'], r['ms'], r['peak_gib'],
                  '' if t is None else '; train step {0:.2f} ms, peak {1:.2f} '
                  'GiB'.format(t['ms'], t['peak_gib'])))
    print('supervised summary: step median {0:.2f} ms after the first, '
          'validation median {1:.2f} ms per volume, eva_main {2:.2f} s'
          .format(float(np.median(supervised['step_ms'][1:])),
                  float(np.median(supervised['valid_ms'])) / N_VOLUMES,
                  sum(supervised['eval_s'])))
    for paradigm, steps in (('ssl', ssl_timed), ('wsl', wsl_timed)):
        for m, r in steps.items():
            print('{0} summary {1}: step {2:.2f} ms, peak {3:.2f} GiB'.format(
                paradigm, m, r['ms'], r['peak_gib']))
    for m, r in nll_steps.items():
        print('nll summary {0}: step {1:.2f} ms, peak {2:.2f} GiB'.format(
            m, r['ms'], r['peak_gib']))
    for m, r in cls_steps.items():
        print('cls summary {0}: step {1:.2f} ms, peak {2:.2f} GiB'.format(
            m, r['ms'], r['peak_gib']))
    print('train step summary: f32 {0:.2f} ms, bf16 {1:.2f} ms, f16 {2:.2f} '
          'ms per step (batch 4+4), peak {3:.2f} / {4:.2f} / {5:.2f} GiB, '
          '{6:.2f} TFLOP per step; card vs CPU gradient max rel err {7:.3g}'
          .format(timed['float32']['ms'], timed['bfloat16']['ms'],
                  timed['float16']['ms'], timed['float32']['peak_gib'],
                  timed['bfloat16']['peak_gib'], timed['float16']['peak_gib'],
                  timed['tflop'], step_check['grad_rel']))
    entry = {
        'name': 'dsbn_prelu', 'route': 'triton', 'source': SOURCE,
        'replaces': REPLACES,
        'launches': (sum(serving[p]['launches'] for p in serving)
                     + sum(fpl[p]['launches'] for p in fpl)
                     + sum(r['launches'] for r in batched)
                     + sum(r['launches'] for r in train.values())
                     + sum(r['launches'] for r in variants.values())
                     + sum(r['launches'] for k, r in paths.items()
                           if isinstance(r, dict))
                     + sum(r['launches'] for r in paradigm_cli.values())
                     + sum(r['launches'] for r in nll_cli.values()
                           if isinstance(r, dict))
                     + cls_cli['launches'] + pool['launches']
                     + tools['launches'] + converter['launches']
                     + scale_out['launches'] + multihost_cli['launches']
                     + nccl['launches']
                     + sum(r['launches'] for r in paradigm_nccl.values())
                     + profile['launches'] + pipeline['launches']
                     + driver['launches'] + half['launches']),
        'max_abs_err': max(e[torch.float32]
                           for e in (max_err, max_err48, max_err24)),
        'max_abs_err_bf16': max(e[torch.bfloat16]
                                for e in (max_err, max_err48, max_err24)),
        'max_abs_err_f16': max(e[torch.float16]
                               for e in (max_err, max_err48, max_err24)),
        'shape': list(big), 'dtype': 'float32',
        'ms': rows[(big, torch.float32)]['ms'], 'plain_ms': plain_ms,
        'bound_ms': rows[(big, torch.float32)]['bound_ms'],
        'bound_by': 'bytes', 'library_ms': None, 'yardstick_ms': yard_ms,
        'conv_bias_fold': {
            'ms': rows[(big, torch.float32)]['fold_ms'],
            'two_pass_ms': rows[(big, torch.float32)]['two_pass_ms'],
            'fpl_ms': rows[(big48, torch.float32)]['fold_ms'],
            'fpl_two_pass_ms': rows[(big48, torch.float32)]['two_pass_ms']},
        'launches_per_volume': serving['float32']['launches'] // N_VOLUMES,
        'ms_per_volume': {p: v[0] for p, v in per_volume.items()},
        'bound_ms_per_volume': {p: v[1] for p, v in per_volume.items()},
        'volume_ms': {p: v[2] for p, v in per_volume.items()},
        'bf16': {'ms': rows[(big, torch.bfloat16)]['ms'],
                 'bound_ms': rows[(big, torch.bfloat16)]['bound_ms'],
                 'plain_ms': rows[(big, torch.bfloat16)]['plain_ms'],
                 'yardstick_ms': rows[(big, torch.bfloat16)]['yard_ms'],
                 'fpl_ms': rows[(big48, torch.bfloat16)]['ms'],
                 'fpl_bound_ms': rows[(big48, torch.bfloat16)]['bound_ms'],
                 'fpl_plain_ms': rows[(big48, torch.bfloat16)]['plain_ms'],
                 'fpl_yardstick_ms': rows[(big48,
                                           torch.bfloat16)]['yard_ms']},
        'f16': {'ms': rows[(big, torch.float16)]['ms'],
                'bound_ms': rows[(big, torch.float16)]['bound_ms'],
                'plain_ms': rows[(big, torch.float16)]['plain_ms'],
                'yardstick_ms': rows[(big, torch.float16)]['yard_ms'],
                'fpl_ms': rows[(big48, torch.float16)]['ms'],
                'fpl_bound_ms': rows[(big48, torch.float16)]['bound_ms'],
                'fpl_plain_ms': rows[(big48, torch.float16)]['plain_ms'],
                'fpl_yardstick_ms': rows[(big48, torch.float16)]['yard_ms'],
                'serving_launches': serving['float16']['launches'],
                'fpl_launches': fpl['float16']['launches']},
        'serving_agree_f32': {p: serving[p]['agree_f32']
                              for p in PRECISIONS[1:]},
        'fpl_rel_f32': {p: fpl[p]['rel_f32'] for p in PRECISIONS[1:]},
        'train_step_ms': {p: timed[p]['ms'] for p in PRECISIONS},
        'train_step_peak_gib': {p: timed[p]['peak_gib'] for p in PRECISIONS},
        'train_loss_rel_f32': {p: timed[p]['loss_rel_f32']
                               for p in PRECISIONS[1:]},
        'train_zero_grad_share': {p: timed['zero_grad'][p]['zero_share']
                                  for p in PRECISIONS},
        'train_logit_grad_zero_share': {
            p: timed['zero_grad'][p]['logit_zero_share']
            for p in PRECISIONS},
        'train_norm_kernels': timed['norm_kernels'],
        'trace_sessions': sessions['sessions'],
        'trace_lost_kernel_events': sessions['lost'],
        'trace_skew_us': sessions['skew_us'],
        'precision_steps': half['steps'],
        'precision_clslsr': {k: half['clslsr'][k]
                             for k in ('launches', 'agree', 'wall_s')},
        'precision_matmul': half['matmul'],
        'precision_wall_s': half['wall_s'],
        'fpl_shape': list(big48),
        'fpl_ms': rows[(big48, torch.float32)]['ms'],
        'fpl_plain_ms': plain48, 'fpl_yardstick_ms': yard48,
        'fpl_bound_ms': rows[(big48, torch.float32)]['bound_ms'],
        'fpl_launches_per_volume': fpl['float32']['launches'] // N_VOLUMES,
        'fpl_ms_per_volume': {p: v[0] for p, v in fpl_kernel.items()},
        'fpl_bound_ms_per_volume': {p: v[1] for p, v in fpl_kernel.items()},
        'fpl_volume_ms': {p: float(np.median(fpl[p]['vol_ms']))
                          for p in fpl},
        'fpl_peak_gib': {p: fpl[p]['peak'] / 2 ** 30 for p in fpl},
        'batched_volume_ms': [r['ms'] for r in batched[:2]],
        'train_cli_launches': {t: r['launches'] for t, r in train.items()},
        'train_eval_forwards': {t: r['forwards'] for t, r in train.items()},
        'variant_launches': {t: r['launches'] for t, r in variants.items()},
        'variant_step_ms': {t: r['step_ms'] for t, r in variants.items()},
        'variant_peak_gib': {t: r['peak_gib'] for t, r in variants.items()},
        'variant_check': variant_check,
        'test_path_launches': {t: r['launches'] for t, r in paths.items()
                               if isinstance(r, dict)},
        'test_path_ms_per_volume': {t: r['ms'] for t, r in paths.items()
                                    if isinstance(r, dict)},
        'eval_s_per_volume': evaluation['s_per_volume'],
        'distance_s': evaluation['distance_s'],
        'supervised_cli_launches': supervised['launches'],
        'paradigm_cli_launches': {t: r['launches']
                                  for t, r in paradigm_cli.items()},
        'paradigm_step_ms': {'{0} {1}'.format(paradigm, m): r['ms']
                             for paradigm, steps in (('ssl', ssl_timed),
                                                     ('wsl', wsl_timed))
                             for m, r in steps.items()},
        'paradigm_check_grad_worst': max(
            r['grad_worst'] for r in list(ssl_check.values())
            + list(wsl_check.values())),
        'nll_cli_launches': {t: r['launches'] for t, r in nll_cli.items()
                             if isinstance(r, dict)},
        'nll_step_ms': {m: r['ms'] for m, r in nll_steps.items()},
        'nll_peak_gib': {m: r['peak_gib'] for m, r in nll_steps.items()},
        'nll_check_grad_worst': max(r['grad_worst']
                                    for r in nll_steps_check.values()),
        'nll_check_mask_diff': {m: r['mask_diff']
                                for m, r in nll_steps_check.items()},
        'cls_cli_launches': cls_cli['launches'],
        'cls_step_ms': {m: r['ms'] for m, r in cls_steps.items()},
        'cls_peak_gib': {m: r['peak_gib'] for m, r in cls_steps.items()},
        'cls_check_grad_worst': max(r['grad_worst']
                                    for r in cls_steps_check.values()),
        'pool_workers': pool['workers'],
        'pool_stream': {str(w): r for w, r in pool['stream'].items()},
        'pool_launches': pool['launches'],
        'pool_step_ms': pool['step_ms'],
        'pool_host_wait_s': pool['host_wait_s'],
        'pool_valid_ms_per_volume': pool['valid_ms'],
        'sync_step_ms': train['gen']['step_ms'],
        'sync_host_wait_s': train['gen']['host_wait_s'],
        'sync_valid_ms_per_volume': train['gen']['valid_ms'],
        'average_test_launches': tools['launches'],
        'converter_launches': converter['launches'],
        'converter_max_abs_err': converter['max_abs_err'],
        'scale_out_launches': scale_out['launches'],
        'scale_out_step': scale_out['step'],
        'scale_out_infer': scale_out['infer'],
        'scale_out_step_s': scale_out['step_s'],
        'scale_out_infer_s': scale_out['infer_s'],
        'multihost_cli_launches': multihost_cli['launches'],
        'nccl_world1_step_ms': nccl['step_ms'],
        'nccl_world1_overhead': nccl['overhead'],
        'nccl_world1_launches': nccl['launches'],
        'scale_out_bytes': bytes_,
        'paradigm_dist': {
            name: {'loss_err': r['compare']['loss_err'],
                   'grad_worst': r['compare']['grad_worst'],
                   'stats_err': r['compare']['stats_err'],
                   'teacher_err': r['compare']['teacher_err'],
                   'mask_diff': r['compare']['mask_diff'],
                   'replica_gaps': r['gaps'], 'one_s': r['one_s'],
                   'rank0_s': r['rank0_s'],
                   'one_peak_gib': r['one_peak_gib'],
                   'rank0_peak_gib': r['rank0_peak_gib'],
                   'bytes_per_step': r['bytes_per_step']}
            for name, r in paradigm_dist['methods'].items()},
        'paradigm_nccl_launches': {t: r['launches']
                                   for t, r in paradigm_nccl.items()},
        'paradigm_nccl_forwards': {t: r['forwards']
                                   for t, r in paradigm_nccl.items()},
        'paradigm_nccl_step_ms': {t: r['step_ms']
                                  for t, r in paradigm_nccl.items()},
        'profile_launches': {k: profile[k]['launches']
                             for k in ('train', 'test')},
        'profile_span_us': {k: profile[k]['span_us']
                            for k in ('train', 'test')},
        'profile_busy_us': {k: profile[k]['busy_us']
                            for k in ('train', 'test')},
        'profile_kernel_busy_us': {k: profile[k]['kernel_busy_us']
                                   for k in ('train', 'test')},
        'profile_trace_bytes': {k: profile[k]['bytes']
                                for k in ('train', 'test')},
        'profile_step_ms': profile['train']['step_ms'],
        'profile_volume_ms': profile['test']['vol_ms'],
        'profile_traced_ms': profile['traced_ms'],
        'profile_event_ms': profile['event_ms'],
        'profile_step_plain_ms': profile['step_plain_ms'],
        'profile_step_profiled_ms': profile['step_profiled_ms'],
        'profile_step_traced_ms': profile['step_traced_ms'],
        'profile_wall_s': profile['wall_s'],
        'pipeline_launches': pipeline['launches'],
        'pipeline_label': pipeline['label'],
        'pipeline_plain': pipeline['plain'],
        'pipeline_fpl': pipeline['fpl'],
        'pipeline_batch': pipeline['batch'],
        'pipeline_batch_agree': pipeline['batch_agree'],
        'pipeline_wall_s': pipeline['wall_s'],
        'driver_launches': {k: driver[k]['launches']
                            for k in ('entry', 'dryrun', 'full')},
        'driver_forwards': {k: driver[k]['forwards']
                            for k in ('dryrun', 'full')},
        'entry_max_abs_err': driver['entry']['max_abs_err'],
        'dryrun_wall_s': driver['dryrun']['wall_s'],
        'pipeline4_stage_s': driver['full']['walls'],
        'pipeline4_total_s': driver['full']['total_s'],
        'pipeline4_fpl_rel': driver['full']['fpl_rel'],
        'pipeline4_wall_s': driver['full']['wall_s'],
        'driver_wall_s': driver['wall_s'],
    }
    print(json.dumps({'kernels': [entry, swin]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
