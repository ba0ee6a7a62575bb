"""Weak-scaling measurement harness.

A weak-scaling sweep of the full sharded training step over 1/2/4/.../N
devices of whatever mesh exists (virtual CPU devices in CI, real cards on
a GPU host), plus analytic per-device communication volumes for the two
collectives the step issues:

  * geometry ``all_gather`` over the 'geo' axis
    (parallel/render.render_geo_sharded / train_step_sharded): each
    device receives (geo-1) shards of the vertex/normal/uv/index/mat
    arrays per step.
  * gradient ``psum``/pmean over the whole mesh: a ring all-reduce moves
    2*(d-1)/d * param_bytes through each device per step.

Weak scaling holds per-device work constant (rays and triangles grow
with the mesh), so efficiency(d) = t(1) / t(d); on a virtual CPU mesh
the numbers exercise the harness and the collective code paths, not the
interconnect.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..core.types import Camera, Scene, scene_to_device
from ..models.inverse import apply_params, init_params
from ..models.procedural import random_triangles
from .mesh import make_mesh
from .render import train_step_sharded


def _tree_bytes(tree) -> int:
    return int(sum(
        int(np.prod(x.shape)) * x.dtype.itemsize
        for x in jax.tree_util.tree_leaves(tree)
        if hasattr(x, "shape")
    ))


def comm_volume_per_device(scene: Scene, params, mesh) -> Dict[str, float]:
    """Analytic bytes moved per device per step by each collective."""
    d = mesh.devices.size
    geo = dict(zip(mesh.axis_names, mesh.devices.shape)).get("geo", 1)
    geo_arrays = (scene.verts, scene.normals, scene.uv, scene.indices,
                  scene.mat_index)
    geo_bytes = _tree_bytes(geo_arrays)
    param_bytes = _tree_bytes(params)
    return {
        "all_gather_bytes": geo_bytes * (geo - 1) / max(1, geo),
        "psum_bytes": 2.0 * param_bytes * (d - 1) / max(1, d),
        "geo_axis": geo,
        "param_bytes": param_bytes,
    }


def weak_scaling_sweep(
    max_devices: int,
    rows_per_device: int = 8,
    width: int = 16,
    tris_per_geo: int = 8,
    bounces: int = 1,
    iters: int = 3,
) -> List[Dict[str, Any]]:
    """Times the full sharded train step at 1, 2, 4, ..., max_devices
    with constant per-device work; returns one record per mesh size."""
    sizes = []
    d = 1
    while d <= max_devices:
        sizes.append(d)
        d *= 2
    if sizes[-1] != max_devices:
        sizes.append(max_devices)

    cam = Camera.default()
    records: List[Dict[str, Any]] = []
    for d in sizes:
        geo = 2 if d % 2 == 0 else 1
        mesh = make_mesh(d, geo=geo)
        rays_size = d // geo
        height = rows_per_device * rays_size
        ntris = tris_per_geo * geo
        cfg = RenderConfig(width=width, height=height, bounces=bounces,
                           leaf_pad_multiple=32)
        scene = scene_to_device(random_triangles(ntris, seed=0))
        params = init_params(scene)
        target = jnp.zeros((height, width, 4), jnp.float32)

        def step(chunks=1):
            return train_step_sharded(
                params, apply_params, scene, cam, target, cfg, mesh,
                grad_chunks=chunks,
            )

        def timeit(chunks):
            jax.block_until_ready(step(chunks))  # compile + warm
            # min over repetitions: the step is overhead-dominated on a
            # virtual mesh and per-run jitter exceeds the d-dependence;
            # the minimum approximates the dispatch floor
            best = float("inf")
            for _ in range(iters):
                t0 = time.perf_counter()
                jax.block_until_ready(step(chunks))
                best = min(best, time.perf_counter() - t0)
            return best

        dt = timeit(1)
        # overlapped-collective schedule (per-chunk psum inside lax.scan;
        # see train_step_sharded grad_chunks) — the delta vs step_ms is
        # the overlap win (or the recompute cost, on comm-free meshes)
        dt_ov = timeit(2) if d > 1 else dt

        rays = width * height * (1 + bounces)
        rec = {
            "devices": d,
            "mesh": dict(zip(mesh.axis_names, mesh.devices.shape)),
            "tris": ntris,
            "rays_per_step": rays,
            "step_ms": dt * 1e3,
            "step_ms_overlapped": dt_ov * 1e3,
            "rays_per_sec": rays / dt,
            **comm_volume_per_device(scene, params, mesh),
        }
        records.append(rec)

    t1 = records[0]["step_ms"]
    for rec in records:
        rec["weak_scaling_efficiency"] = t1 / rec["step_ms"]
    return records


def scaling_report(records) -> Dict[str, Any]:
    """The sweep's records with the platform they ran on, as one dict."""
    return {
        "platform": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "devices": jax.device_count(),
        "note": (
            "weak scaling: per-device work constant; efficiency = "
            "t(1)/t(d).  On a virtual CPU mesh the devices share the "
            "host's cores, so the sweep checks the sharded program and "
            "its collectives, not interconnect scaling."
        ),
        "records": records,
    }

