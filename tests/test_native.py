"""C++ native components vs their Python counterparts (differential tests,
the rebuild's version of the reference's cross-implementation validation)."""

import numpy as np
import pytest

from gseg.config import SegmentationConfig
from gseg.metrics.compare import asa_ue
from gseg.models.felzenszwalb_cpu import segment_kruskal_np
from gseg.native import bindings
from gseg.utils.labels import canonical_min_labels_np
from gseg.utils.synthetic import blobs_image

pytestmark = pytest.mark.skipif(
    not bindings.available(), reason="native library not buildable"
)


@pytest.mark.parametrize("seed", [0, 1])
def test_native_kruskal_matches_numpy(seed):
    cfg = SegmentationConfig(sigma=0.8, k=100.0, min_size=8)
    img = blobs_image(24, 32, 5, 6.0, seed)
    a = canonical_min_labels_np(segment_kruskal_np(img, cfg))
    b = canonical_min_labels_np(bindings.segment_kruskal_native(img, cfg))
    assert np.array_equal(a, b)


def test_native_asa_ue_matches_numpy():
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 7, (20, 30)).astype(np.int32)
    gt = rng.integers(0, 5, (20, 30)).astype(np.int32)
    a_np, u_np = asa_ue(seg, gt)
    a_c, u_c = bindings.asa_ue_native(seg, gt)
    assert abs(a_np - a_c) < 1e-9
    assert abs(u_np - u_c) < 1e-9


def test_native_perfect_segmentation():
    gt = np.repeat(np.arange(4), 25).reshape(10, 10).astype(np.int32)
    a, u = bindings.asa_ue_native(gt.copy(), gt)
    assert a == 1.0 and u == 0.0
