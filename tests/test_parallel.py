"""Multi-device parallel layer on the 8-virtual-CPU-device mesh
(SURVEY.md §2.4 S10/S11: vmap batching + spatial sharding)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gseg.config import SegmentationConfig
from gseg.models.atomic_boruvka import segment_atomic
from gseg.parallel.batching import (
    data_parallel_mesh,
    segment_batch,
    segment_batch_sharded,
)
from gseg.parallel.spatial import multichip_step, segment_spatial, spatial_mesh
from gseg.utils.synthetic import blobs_image

needs_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def cfg():
    return SegmentationConfig(k=120.0, min_size=4, max_iters=16)


def test_segment_batch(cfg):
    imgs = np.stack([blobs_image(16, 24, 4, 5.0, s) for s in range(2)])
    out = np.asarray(segment_batch(jnp.asarray(imgs), cfg))
    assert out.shape == (2, 16, 24)
    single = np.asarray(segment_atomic(jnp.asarray(imgs[0]), cfg))
    assert np.array_equal(out[0], single)


@needs_devices
def test_segment_batch_sharded(cfg):
    mesh = data_parallel_mesh(jax.devices()[:8])
    imgs = np.stack([blobs_image(16, 24, 4, 5.0, s) for s in range(8)])
    out = np.asarray(segment_batch_sharded(jnp.asarray(imgs), cfg, mesh))
    single = np.asarray(segment_atomic(jnp.asarray(imgs[3]), cfg))
    assert np.array_equal(out[3], single)


@needs_devices
def test_segment_spatial_matches_single_device(cfg):
    mesh = spatial_mesh(jax.devices()[:4])
    img = blobs_image(32, 24, 4, 5.0, 0)
    out = np.asarray(segment_spatial(jnp.asarray(img), cfg, mesh))
    single = np.asarray(segment_atomic(jnp.asarray(img), cfg))
    assert np.array_equal(out, single)


@needs_devices
def test_multichip_step_2d_mesh(cfg):
    import numpy as _np
    from jax.sharding import Mesh

    mesh = Mesh(_np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "space"))
    imgs = np.stack([blobs_image(16, 24, 4, 5.0, s) for s in range(4)])
    out = np.asarray(multichip_step(jnp.asarray(imgs), cfg, mesh))
    assert out.shape == (4, 16, 24)
    single = np.asarray(segment_atomic(jnp.asarray(imgs[1]), cfg))
    assert np.array_equal(out[1], single)


def test_segment_batch_turbo():
    from gseg.models.turbo import segment_turbo
    from gseg.utils.labels import canonical_min_labels_np

    cfg = SegmentationConfig(k=120.0, min_size=4, max_iters=16,
                             algorithm="turbo")
    imgs = np.stack([blobs_image(16, 24, 4, 5.0, s) for s in range(2)])
    out = np.asarray(segment_batch(jnp.asarray(imgs), cfg))
    single = np.asarray(segment_turbo(jnp.asarray(imgs[0]), cfg))
    assert np.array_equal(out[0], single)


@needs_devices
def test_turbo_spatial_matches_dense():
    """Explicit shard_map turbo (halo-exchange gossip, gathered extraction,
    replicated stage 2) equals the dense single-device turbo partition."""
    from gseg.models.turbo import segment_turbo
    from gseg.parallel.turbo_spatial import segment_turbo_spatial

    cfg = SegmentationConfig(k=120.0, min_size=8)
    img = blobs_image(48, 40, 5, 6.0, 2)
    mesh = spatial_mesh(jax.devices()[:8])
    labels, flags = segment_turbo_spatial(jnp.asarray(img), cfg, mesh)
    assert int(flags) == 0
    dense = np.asarray(segment_turbo(jnp.asarray(img), cfg))
    assert np.array_equal(np.asarray(labels), dense)


@needs_devices
def test_turbo_spatial_quality_mode_matches_dense():
    """Quality mode (weight_buckets) on the shard_map path: the gathered
    global threshold sample, bucket ramp, and stage-2 schedule must
    reproduce the dense partition exactly."""
    from gseg.models.turbo import segment_turbo
    from gseg.parallel.turbo_spatial import segment_turbo_spatial

    cfg = SegmentationConfig(k=30.0, min_size=10, weight_buckets=16)
    img = blobs_image(48, 40, 5, 6.0, 3)
    mesh = spatial_mesh(jax.devices()[:8])
    labels, flags = segment_turbo_spatial(
        jnp.asarray(img), cfg, mesh, gossip_rounds=4
    )
    assert int(flags) == 0
    dense = np.asarray(segment_turbo(jnp.asarray(img), cfg,
                                     gossip_rounds=4))
    assert np.array_equal(np.asarray(labels), dense)


@needs_devices
def test_turbo_spatial_minsize_and_edgecases():
    from gseg.models.turbo import segment_turbo
    from gseg.parallel.turbo_spatial import segment_turbo_spatial

    cfg = SegmentationConfig(k=60.0, min_size=20)
    img = blobs_image(64, 24, 6, 8.0, 5)
    mesh = spatial_mesh(jax.devices()[:4])
    labels, flags = segment_turbo_spatial(jnp.asarray(img), cfg, mesh)
    assert int(flags) == 0
    dense = np.asarray(segment_turbo(jnp.asarray(img), cfg))
    assert np.array_equal(np.asarray(labels), dense)


def test_segment_batch_fastmst_and_superpixel():
    """Batched compact-round paths (lax.map of the flagged impls)."""
    from gseg.models.fastmst import segment_fastmst
    from gseg.models.superpixel import segment_superpixel

    imgs = np.stack([blobs_image(16, 24, 4, 5.0, s) for s in range(2)])
    for algo, single in (
        ("fastmst", segment_fastmst), ("superpixel", segment_superpixel)
    ):
        cfg = SegmentationConfig(k=120.0, min_size=4, algorithm=algo,
                                 max_iters=16)
        out = np.asarray(segment_batch(jnp.asarray(imgs), cfg))
        ref = np.asarray(single(jnp.asarray(imgs[1]), cfg))
        assert np.array_equal(out[1], ref)
