"""Sequential-oracle sanity: partition validity, parameter monotonicity,
Kruskal vs Boruvka agreement on easy inputs. (SURVEY.md §4: the oracles are
executable specifications, so they get their own invariant tests.)"""

import numpy as np
import pytest

from gseg.config import SegmentationConfig
from gseg.models.boruvka_cpu import segment_boruvka_np
from gseg.models.felzenszwalb_cpu import segment_kruskal_np
from gseg.utils.labels import compact_labels_np, num_components
from gseg.utils.synthetic import blobs_image, checkerboard_image, gradient_image


def _assert_valid_labels(labels, h, w):
    assert labels.shape == (h, w)
    assert labels.dtype == np.int32
    # labels are root vertex ids: every pixel's label is a pixel index whose
    # own label is itself (roots are fixed points)
    flat = labels.ravel()
    assert np.all(flat >= 0) and np.all(flat < h * w)
    assert np.array_equal(flat[flat], flat)


@pytest.mark.parametrize("segment_fn", [segment_boruvka_np, segment_kruskal_np])
def test_partition_valid(segment_fn, small_image, small_cfg):
    h, w = small_image.shape[:2]
    labels = segment_fn(small_image, small_cfg)
    _assert_valid_labels(labels, h, w)


@pytest.mark.parametrize("segment_fn", [segment_boruvka_np, segment_kruskal_np])
def test_min_size_enforced(segment_fn, small_image):
    cfg = SegmentationConfig(k=50.0, min_size=30)
    labels = segment_fn(small_image, cfg)
    _, counts = np.unique(labels, return_counts=True)
    assert counts.min() >= 30 or counts.size == 1


@pytest.mark.parametrize("segment_fn", [segment_boruvka_np, segment_kruskal_np])
def test_k_monotone_component_count(segment_fn, small_image):
    """Larger k merges at least as aggressively (fewer or equal components)."""
    counts = []
    for k in (20.0, 100.0, 500.0):
        cfg = SegmentationConfig(k=k, min_size=1)
        counts.append(num_components(segment_fn(small_image, cfg)))
    assert counts[0] >= counts[1] >= counts[2]


def test_flat_image_single_component():
    img = np.full((16, 20, 3), 127, dtype=np.uint8)
    cfg = SegmentationConfig(k=10.0, min_size=1)
    assert num_components(segment_boruvka_np(img, cfg)) == 1
    assert num_components(segment_kruskal_np(img, cfg)) == 1


def test_checkerboard_respects_strong_edges():
    img = checkerboard_image(24, 24, cell=6)
    cfg = SegmentationConfig(sigma=0.1, k=5.0, min_size=1)
    labels = segment_kruskal_np(img, cfg)
    cells = compact_labels_np(labels)
    # each 6x6 cell should be uniform
    for y in range(0, 24, 6):
        for x in range(0, 24, 6):
            assert np.unique(cells[y : y + 6, x : x + 6]).size == 1


def test_gradient_terminates():
    img = gradient_image(20, 28)
    cfg = SegmentationConfig(k=1000.0, min_size=1)
    assert num_components(segment_boruvka_np(img, cfg)) == 1
