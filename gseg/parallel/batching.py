"""Batch parallelism: vmap over images, optionally sharded over a device mesh.

The reference processes one image at a time (SURVEY.md §2.4 S10: batch
parallelism absent upstream); here `jax.vmap` / `lax.map` turn every
per-image pipeline into a batched one (BASELINE.json config 5: batched 4K
video frames), and a 1-D device mesh scales the batch across devices —
the data-parallel axis of this workload.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SegmentationConfig


def _segment_batch_impl(images: jnp.ndarray, cfg: SegmentationConfig):
    """Returns (labels (B, H, W), flags () int32 OR over the batch)."""
    from ..models.atomic_boruvka import segment_atomic_impl
    from ..models.fastmst import segment_fastmst_impl
    from ..models.superpixel import segment_superpixel_impl
    from ..models.turbo import segment_turbo_impl

    if cfg.algorithm == "atomic":
        labels = jax.vmap(lambda im: segment_atomic_impl(im, cfg))(images)
        return labels, jnp.int32(0)

    # lax.map (one jitted program, sequential over the batch) for the
    # compact-round paths: their data-adaptive while_loops (and turbo's GPU
    # tile-pass kernels) don't vmap, and per-image convergence avoids
    # vmap's lockstep worst-case. Flags are OR-reduced over the batch.
    fn = {
        "turbo": segment_turbo_impl,
        "fastmst": segment_fastmst_impl,
        "superpixel": segment_superpixel_impl,
    }[cfg.algorithm]
    labels, flags = jax.lax.map(lambda im: fn(im, cfg), images)
    return labels, jax.lax.associative_scan(jnp.bitwise_or, flags)[-1]


segment_batch_flagged = jax.jit(_segment_batch_impl, static_argnames=("cfg",))


def segment_batch(images: jnp.ndarray, cfg: SegmentationConfig) -> jnp.ndarray:
    """(B, H, W, 3) -> (B, H, W) int32 labels, one jitted vmapped program.

    Checks the turbo path's capacity flags on the host (once per batch; see
    models.turbo.segment_turbo for the per-image semantics)."""
    labels, flags = segment_batch_flagged(images, cfg)
    if int(flags) != 0:
        from ..models.turbo import describe_flags

        if cfg.on_overflow == "fallback":
            from ..models.atomic_boruvka import segment_atomic_impl

            return jax.jit(
                jax.vmap(lambda im: segment_atomic_impl(im, cfg)),
            )(images)
        if cfg.on_overflow != "ignore":
            raise RuntimeError(
                "turbo capacity/budget violation in batch: "
                + describe_flags(int(flags))
            )
    return labels


@functools.lru_cache(maxsize=16)
def _sharded_program(cfg: SegmentationConfig, mesh: Mesh, axis: str):
    """Per-device batch program under shard_map, built once per
    configuration so that repeated calls reuse its compilation."""

    def local(ims):
        labels, flags = _segment_batch_impl(ims, cfg)
        return labels, flags.reshape(1)

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(axis), out_specs=(P(axis), P(axis)),
        check_vma=False,
    ))


def data_parallel_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (axis,))


def segment_batch_sharded(
    images: jnp.ndarray, cfg: SegmentationConfig, mesh: Mesh, axis: str = "data"
) -> jnp.ndarray:
    """Data-parallel batched segmentation: batch axis sharded over the mesh.

    Each device segments its own images with the single-device program
    (`shard_map`), so no cross-device traffic occurs inside the Boruvka
    loop — the embarrassingly-parallel scale-out mode (SURVEY.md §5
    distributed-communication row). An explicit per-device program also
    keeps turbo's GPU tile-pass kernels local: an FFI call has no sharding
    rule, so a partitioner would replicate it. B must be divisible by the
    mesh axis size.
    """
    import numpy as np

    n_dev = mesh.shape[axis]
    if images.shape[0] % n_dev:
        raise ValueError(
            f"batch {images.shape[0]} not divisible by mesh axis size {n_dev}")
    images = jax.device_put(images, NamedSharding(mesh, P(axis)))
    labels, flags = _sharded_program(cfg, mesh, axis)(images)
    flags = int(np.bitwise_or.reduce(np.asarray(flags)))
    if flags != 0 and cfg.on_overflow == "raise":
        from ..models.turbo import describe_flags

        raise RuntimeError(
            "turbo capacity/budget violation in sharded batch: "
            + describe_flags(flags)
        )
    return labels
