"""Host-side segmentation metrics (numpy, scipy and the C++ distance
transform of ``fpl_plus_torch.native``).

Parity with the reference metrics (PyMIC/pymic/util/evaluation_seg_train.py:
21-262) and the JAX package's ``metrics/seg_metrics.py``: dice and iou with
the 1e-5 smooth terms, edges as the mask minus its face-connected erosion,
ASSD and HD95 on raster-scan distance maps (GeodisTK's lamb 0, 2
iterations, zero image), the ASSD clamp at 50, and an empty pair: both
empty scores 0, one empty scores 50 (the reference crashes there).

The 2D surface distances take the spacing as the 3D ones do. The reference
ignores it in 2D (``GeodisTK.geodesic2d_raster_scan`` has no spacing
argument, evaluation_seg_train.py:122-123), so its 2D ASSD/HD95 are in
pixels; with unit spacing the two agree, and every shipped recipe is 3D.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

from fpl_plus_torch.native import raster_scan_distance


def binary_dice(s: np.ndarray, g: np.ndarray) -> float:
    if s.ndim != g.ndim:
        raise ValueError('dice of a {0}D and a {1}D mask'.format(s.ndim,
                                                                  g.ndim))
    s0 = float(np.multiply(s, g).sum())
    return (2.0 * s0 + 1e-5) / (float(s.sum()) + float(g.sum()) + 1e-5)


def binary_iou(s: np.ndarray, g: np.ndarray) -> float:
    if s.ndim != g.ndim:
        raise ValueError('iou of a {0}D and a {1}D mask'.format(s.ndim,
                                                                 g.ndim))
    inter = float(np.multiply(s, g).sum())
    union = float(np.asarray(s + g > 0, np.float32).sum())
    return (inter + 1e-5) / (union + 1e-5)


def get_edge_points(img: np.ndarray) -> np.ndarray:
    """The mask minus its face-connected erosion (reference :84-98)."""
    strt = ndimage.generate_binary_structure(img.ndim, 1)
    ero = ndimage.binary_erosion(img, strt)
    return np.asarray(img, np.uint8) - np.asarray(ero, np.uint8)


def _surface_distances(s: np.ndarray, g: np.ndarray, spacing=None):
    if s.ndim != g.ndim:
        raise ValueError('surface distance of a {0}D and a {1}D mask'.format(
            s.ndim, g.ndim))
    if spacing is None:
        spacing = [1.0] * s.ndim
    elif len(spacing) != s.ndim:
        raise ValueError('spacing {0} for a {1}D mask'.format(list(spacing),
                                                               s.ndim))
    s_edge = get_edge_points(s)
    g_edge = get_edge_points(g)
    return (s_edge, g_edge, raster_scan_distance(s_edge, spacing),
            raster_scan_distance(g_edge, spacing))


def binary_hd95(s: np.ndarray, g: np.ndarray, spacing=None) -> float:
    s_edge, g_edge, s_dis, g_dis = _surface_distances(s, g, spacing)
    if s_edge.sum() == 0 or g_edge.sum() == 0:
        return 0.0 if s_edge.sum() == g_edge.sum() else 50.0
    dist_list1 = np.sort(s_dis[g_edge > 0])
    dist1 = dist_list1[int(len(dist_list1) * 0.95)]
    dist_list2 = np.sort(g_dis[s_edge > 0])
    dist2 = dist_list2[int(len(dist_list2) * 0.95)]
    return float(max(dist1, dist2))


def binary_assd(s: np.ndarray, g: np.ndarray, spacing=None) -> float:
    s_edge, g_edge, s_dis, g_dis = _surface_distances(s, g, spacing)
    ns, ng = float(s_edge.sum()), float(g_edge.sum())
    if ns + ng == 0:
        return 0.0
    assd = (float((s_dis * g_edge).sum()) + float((g_dis * s_edge).sum())) \
        / (ns + ng)
    return min(assd, 50.0)     # reference clamp (:169-170)


def binary_relative_volume_error(s: np.ndarray, g: np.ndarray) -> float:
    s_v, g_v = float(s.sum()), float(g.sum())
    if g_v <= 0:
        raise ValueError('relative volume error of an empty ground truth')
    return abs(s_v - g_v) / g_v


def get_binary_evaluation_score(s_volume, g_volume, spacing, metric) -> float:
    if s_volume.ndim == 4:
        if s_volume.shape[0] != 1 or g_volume.shape[0] != 1:
            raise ValueError('a 4D volume must have one channel')
        s_volume, g_volume = s_volume[0], g_volume[0]
    if s_volume.shape[0] == 1:
        s_volume, g_volume = s_volume[0], g_volume[0]
    metric = metric.lower()
    if metric == 'dice':
        return binary_dice(s_volume, g_volume)
    if metric == 'iou':
        return binary_iou(s_volume, g_volume)
    if metric == 'assd':
        return binary_assd(s_volume, g_volume, spacing)
    if metric == 'hd95':
        return binary_hd95(s_volume, g_volume, spacing)
    if metric == 'rve':
        return binary_relative_volume_error(s_volume, g_volume)
    if metric == 'volume':
        return float(g_volume.sum()) * float(np.prod(spacing))
    raise ValueError('unsupported evaluation metric: {0}'.format(metric))


def get_multi_class_evaluation_score(s_volume, g_volume, label_list,
                                     fuse_label, spacing, metric):
    """One score per label of ``label_list``; ``fuse_label`` merges the
    listed labels into one foreground and scores it alone."""
    if fuse_label:
        s_sub = np.zeros_like(s_volume)
        g_sub = np.zeros_like(g_volume)
        for lab in label_list:
            s_sub = s_sub + np.asarray(s_volume == lab, np.uint8)
            g_sub = g_sub + np.asarray(g_volume == lab, np.uint8)
        label_list = [1]
        s_volume = np.asarray(s_sub > 0, np.uint8)
        g_volume = np.asarray(g_sub > 0, np.uint8)
    return [get_binary_evaluation_score(s_volume == lab, g_volume == lab,
                                        spacing, metric)
            for lab in label_list]
