"""ASA/UE comparetool tests against hand-computable cases."""

import numpy as np
import jax.numpy as jnp

from gseg.metrics.compare import asa_ue, asa_ue_best_gt, asa_ue_jax
from gseg.utils.labels import compact_labels_np


def test_perfect_segmentation():
    gt = np.repeat(np.arange(4), 25).reshape(10, 10)
    asa, ue = asa_ue(gt.copy(), gt)
    assert asa == 1.0 and ue == 0.0


def test_known_overlap():
    # 10x10: gt = left/right halves. seg = top/bottom halves.
    gt = np.zeros((10, 10), int); gt[:, 5:] = 1
    seg = np.zeros((10, 10), int); seg[5:, :] = 1
    asa, ue = asa_ue(seg, gt)
    # each seg half overlaps each gt half by 25 px -> best overlap 25+25
    assert asa == 0.5
    # UE: per pair min(25, 50-25) = 25, four pairs -> 100/100
    assert ue == 1.0


def test_single_component_seg():
    gt = np.zeros((8, 8), int); gt[:, 4:] = 1
    seg = np.zeros((8, 8), int)
    asa, ue = asa_ue(seg, gt)
    assert asa == 0.5  # one comp, max overlap 32 / 64
    assert ue == 1.0   # per gt half: min(32, 64-32) = 32; (32+32) / 64


def test_best_gt_selection():
    seg = np.zeros((6, 6), int); seg[:, 3:] = 1
    gt_bad = np.arange(36).reshape(6, 6)
    gt_good = seg.copy()
    asa, ue = asa_ue_best_gt(seg, [gt_bad, gt_good])
    assert asa == 1.0 and ue == 0.0


def test_labels_need_not_be_compact():
    gt = np.zeros((6, 6), int); gt[:, 3:] = 7777
    seg = np.zeros((6, 6), int); seg[:, 3:] = 123456
    asa, ue = asa_ue(seg, gt)
    assert asa == 1.0 and ue == 0.0


def test_jax_matches_numpy():
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 5, (16, 16))
    gt = rng.integers(0, 4, (16, 16))
    a_np, u_np = asa_ue(seg, gt)
    a_jx, u_jx = asa_ue_jax(
        jnp.asarray(compact_labels_np(seg)), jnp.asarray(compact_labels_np(gt)),
        num_seg=5, num_gt=4,
    )
    assert abs(float(a_jx) - a_np) < 1e-6
    assert abs(float(u_jx) - u_np) < 1e-6
