"""fpl_plus_torch: the PyTorch/CUDA port of the FPL+ framework (Filtered
Pseudo Label-based UDA for 3D medical image segmentation), for one NVIDIA
H100.

The port sits beside the JAX package and mirrors its layout module by
module, so every counterpart is found under the same path. It imports
``torch``, ``numpy`` and ``scipy`` and nothing of the JAX package: host code
it needs is copied here, trimmed to what the ported slices use. Convolutions
run through cuDNN; the eval-mode DSBN+PReLU pair is a hand-written Triton
kernel (``ops/dsbn_prelu.py``).

Layer map (mirrors reference layers L0-L10, see SURVEY.md):
  config/      INI-compatible experiment configuration (L9)
  io/          NIfTI codec + CSV-manifest, .npy and HDF5 datasets (caches,
               FPL+ weights), loader with its worker-process pool,
               prefetch (L1)
  transforms/  sample-dict transform pipeline with recorded inverses (L2)
  models/      torch networks: UNet2D5 with DSBN, the UNet2D and UNet3D
               families, AEs, the discriminator (L3)
  losses/      the segmentation losses, combined and deep supervision (L4)
  engine/      the DSBN train steps (joint with accumulation, alternating,
               dual consistency, discriminator), optimizers and schedules,
               sliding-window inference, folded MC-dropout passes and the
               FPL reduction, checkpoints (L5/L6 compute)
  agents/      orchestration agents: the segmentation train and test
               stages (L5)
  parallel/    scale-out: data-parallel training and sharded inference
               over ranks, one card each; the process group
  metrics/     dice / iou / assd / hd95 / rve / volume and the eva_main
               reports (``python -m fpl_plus_torch.metrics``)
  native/      the C++ raster-scan distance transform (ctypes, built at
               first use)
  ops/         hand-written Hopper kernels with their plain versions
  fpl/         FPL+ weight and data tools (``python -m fpl_plus_torch.fpl``)
  utils/       weight bridge and JAX-checkpoint converter (with its flax
               msgpack reader), checkpoint surgery, offline preprocessing,
               image ops, post-processing, precision policy, scalar curves
  device.py    explicit device resolution (the card unless told otherwise)
  cli.py       command-line entry points (L8)

Ported so far: the training stage in all the segmentation agent's
variants (joint with gradient accumulation, alternating with the entropy
term, the discriminator, dual consistency; Adam, ``.pt`` checkpoints,
resume, in-training validation), the test stages — pseudo labels (sliding
window + flip TTA, multi-head outputs, batched serving, checkpoint
ensembles, inverse transforms on the device or the host, post-processing)
and the FPL MC-dropout uncertainty pass — the evaluation reports, the FPL
weight tools, and every network, segmentation loss and transform of the
JAX package's registries; the SSL, WSL, NLL and classification agents; the
loader's worker pool, the converter of JAX checkpoints and the host tools;
scale-out of the segmentation agent (the paradigm agents' data-parallel
steps are queued in ROADMAP.md).
"""

__version__ = "0.1.0"
