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
  io/          NIfTI codec + CSV-manifest datasets + sync loader (L1)
  transforms/  sample-dict transform pipeline with recorded inverses (L2)
  models/      torch networks incl. DSBN variants (L3)
  engine/      sliding-window inference, checkpoints (L5/L6 compute)
  agents/      orchestration agents: the segmentation test stage (L5)
  ops/         hand-written Hopper kernels with their plain versions
  utils/       weight bridge, label ops, precision policy (shared)
  device.py    explicit device resolution (the card unless told otherwise)
  cli.py       command-line entry points (L8)

Ported so far: the pseudo-label test stage (sliding window + flip TTA) on
UNet2D5_dsbn / UNet2D5. Training, the FPL uncertainty pass and the other
agents and networks are queued in ROADMAP.md.
"""

__version__ = "0.1.0"
