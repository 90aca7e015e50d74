"""Segmentation metrics and the eva_main reports (host numpy; ``python -m
fpl_plus_torch.metrics cfg`` runs the evaluation alone)."""
