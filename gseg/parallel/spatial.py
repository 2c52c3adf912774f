"""Spatial (multi-chip) parallelism: one image sharded across devices.

The reference is single-GPU; its only scaling axis is image resolution, capped
at 2^26 pixels by edge-key packing (Report.pdf p.4; SURVEY.md §5 long-context
row). The answer here to images beyond one device is spatial tiling over
the device mesh — the closest analog of sequence/context parallelism for this
workload:

  - the image (and every (H, W) plane derived from it) is sharded by rows
    over mesh axis "space";
  - filter + edge-weight stages need only halo rows from neighbors;
  - the Boruvka loop's gathers/scatters address the global vertex space.

Two implementations:

  1. `segment_spatial` (this file, default): the GSPMD path. The whole
     atomic pipeline is jitted with sharded inputs/outputs and XLA's SPMD
     partitioner inserts the collectives (halo exchanges for the static
     shifts, all-to-alls for the component scatters) — the standard
     mesh+annotate+let-XLA-partition recipe. Bit-identical to the
     single-device result by construction.

  2. A tile-local Boruvka with explicit `shard_map` + `ppermute` boundary
     merge (planned, SURVEY.md §7 Layer F): contract tile-interior MSTs
     locally, then merge the (small) boundary-edge graphs — Boruvka is
     associative over partitions. Lower traffic; lands with the perf layer.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SegmentationConfig


def spatial_mesh(devices=None, axis: str = "space") -> Mesh:
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def segment_spatial(
    image: jnp.ndarray,
    cfg: SegmentationConfig,
    mesh: Mesh,
    axis: str = "space",
) -> jnp.ndarray:
    """Segment one image sharded by rows across the mesh.

    image (H, W, 3) with H divisible by the mesh size. Returns (H, W) int32
    labels, row-sharded. Labels are root vertex ids — identical to the
    single-device result (GSPMD computes the same function).
    """
    in_sh = NamedSharding(mesh, P(axis, None, None))
    image = jax.device_put(image, in_sh)
    return _spatial_program(cfg, mesh, axis)(image)


@functools.lru_cache(maxsize=16)
def _spatial_program(cfg, mesh, axis):
    """Built once per configuration so repeated calls reuse the compile."""
    from ..models.atomic_boruvka import segment_atomic_impl

    return jax.jit(
        functools.partial(segment_atomic_impl, cfg=cfg),
        in_shardings=NamedSharding(mesh, P(axis, None, None)),
        out_shardings=NamedSharding(mesh, P(axis, None)),
    )


def multichip_step(
    images: jnp.ndarray,
    cfg: SegmentationConfig,
    mesh: Mesh,
    batch_axis: str = "data",
    space_axis: str = "space",
):
    """The full multi-chip step over a 2-D (data x space) mesh.

    images (B, H, W, 3): batch sharded over `batch_axis` (dp), rows of every
    image sharded over `space_axis` (the sp/cp analog). Returns (B, H, W)
    labels sharded the same way. This is the program `__graft_entry__.
    dryrun_multichip` compiles and executes on a virtual mesh.
    """
    in_sh = NamedSharding(mesh, P(batch_axis, space_axis, None, None))
    images = jax.device_put(images, in_sh)
    return _step_program(cfg, mesh, batch_axis, space_axis)(images)


@functools.lru_cache(maxsize=16)
def _step_program(cfg, mesh, batch_axis, space_axis):
    """Built once per configuration so repeated calls reuse the compile."""
    from ..models.atomic_boruvka import segment_atomic_impl

    return jax.jit(
        lambda ims: jax.vmap(lambda im: segment_atomic_impl(im, cfg))(ims),
        in_shardings=NamedSharding(
            mesh, P(batch_axis, space_axis, None, None)),
        out_shardings=NamedSharding(mesh, P(batch_axis, space_axis, None)),
    )
