#!/bin/bash
# FPL+ VS pipeline on the PyTorch port (the JAX package's run.sh, line for line;
# every stage runs on cuda:0, a multi-card mesh from the configs' mesh keys).
# Stage 1: pseudo-label generator (dual-domain DSBN)
python -m fpl_plus_torch.cli train  config_dual/data_vs/vs_t1s_g.cfg
# Stage 2: pseudo labels + FPL uncertainty pass
python -m fpl_plus_torch.cli test   config_dual/data_vs/vs_t1s_g.cfg
python -m fpl_plus_torch.cli test   config_dual/data_vs/vs_t1s_weights.cfg
# Stage 3: filtering weights
python -m fpl_plus_torch.fpl pixel-weight --pseudo-target results_dual/vs_t1s_g_train_hrT2 \
    --pseudo-fake-source results_dual/vs_t1s_g_train_hrT2-ceT1_cyc \
    --output dataset/hrT2_pixel-weight
python -m fpl_plus_torch.fpl image-weight --uncertainty dataset/weight/uncertainty_sorted.npy \
    --output-csv config_dual/data_vs/train_vs_t1s_wi+wp.csv \
    --image-dir dataset/hrT2_train/img \
    --pseudo-label-dir results_dual/vs_t1s_g_train_hrT2 \
    --pixel-weight-dir dataset/hrT2_pixel-weight
# Stage 4: final segmentor (resumes the generator, weighted dice)
python -m fpl_plus_torch.cli train  config_dual/data_vs/vs_t1s_S.cfg
