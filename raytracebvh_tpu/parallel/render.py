"""Sharded rendering and the distributed training step.

Two levels of explicitness, both producing bit-identical images to the
single-device pipeline:

  * ``render_sharded`` — jit + sharding constraints: rays (pixels) are
    sharded over the 'rays' mesh axis, the scene is replicated, and XLA
    propagates shardings through the whole frame (the BVH build is small
    and replicates; traversal/shading are elementwise+gather and shard
    cleanly).  Zero collectives in the forward pass — rays are
    embarrassingly parallel, exactly like the reference's independent
    15x15 pixel threadgroups (Graphics.cpp:788-792).

  * ``render_geo_sharded`` — shard_map with *explicit* collectives:
    geometry arrays arrive sharded over the 'geo' axis and are
    all-gathered before the local build+trace; each device then
    traces only its ray tile.  This is the scaling path for scenes too
    large to replicate (BASELINE.md config 5).

``train_step_sharded`` runs the inverse-rendering objective with
jax.grad *inside* shard_map: per-device gradients over the local ray tile
are psum'd over the mesh — the gradient all-reduce of a data-parallel
training step.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import RenderConfig
from ..core.types import Camera, Rays, Scene
from ..pipeline import (
    build_bvh,
    light_in_ray_space,
    make_rays,
    render_frame,
    shade_rays,
)
from ..camera import camera_matrices
from .mesh import GEO_AXIS, RAYS_AXIS, ray_axes, ray_sharded, replicated


def render_sharded(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh):
    """Rays sharded over the mesh via sharding constraints (pjit style)."""

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def _render(scene, camera, cfg):
        img = render_frame(scene, camera, cfg)
        return jax.lax.with_sharding_constraint(
            img, NamedSharding(mesh, P(ray_axes(mesh), None, None))
        )

    scene = jax.device_put(scene, replicated(mesh))
    camera = jax.device_put(camera, replicated(mesh))
    return _render(scene, camera, cfg)


def _trace_tile(scene: Scene, bvh, rays: Rays, cfg: RenderConfig, wvp=None):
    """Launch + bounces (+ refraction + shadows) for a tile of rays
    (inside shard_map); the SoA chain from pipeline.py."""
    light3 = None
    if cfg.enable_shadows and wvp is not None:
        light3 = light_in_ray_space(cfg, wvp, wvp.dtype)
    return shade_rays(scene, bvh, rays, cfg, light3)


def render_geo_sharded(
    scene: Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh
):
    """Geometry sharded over 'geo' (explicit all_gather), rays over 'rays'.

    Host-side requirement: scene arrays must divide evenly by the mesh
    axis sizes (use parallel.mesh.pad_to_multiple when preparing the
    scene; OBJ scenes pad with degenerate triangles).
    """
    wvp, wv = camera_matrices(camera, cfg.width, cfg.height)
    rays = make_rays(camera, cfg)

    geo_spec = Scene(
        verts=P(GEO_AXIS),
        normals=P(GEO_AXIS),
        uv=P(GEO_AXIS),
        indices=P(GEO_AXIS),
        mat_index=P(GEO_AXIS),
        materials=jax.tree_util.tree_map(lambda _: P(), scene.materials),
        textures=P(),
        tex_hw=P(),
    )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(geo_spec, P(), P(),
                  Rays(origin=P(ray_axes(mesh)), direction=P(ray_axes(mesh)))),
        out_specs=P(ray_axes(mesh)),
        check_vma=False,
    )
    def _tile(scene_shard: Scene, wvp, wv, rays_tile: Rays):
        # Sharded LEAF STAGE: each device transforms only its vertex
        # shard and computes morton codes + leaf AABBs only for its face
        # shard; the all-gathers ship *derived* leaf arrays
        # (BASELINE.md: "triangles ... sharded with an all-gather"; the
        # reference has no multi-device path at all, SURVEY.md 2.3).
        # Only the sort/topology/fit/link assembly stays replicated.
        from ..camera import transform_normals, transform_points
        from ..ops import morton as morton_ops
        from ..pipeline import assemble_bvh

        dtype = jnp.dtype(cfg.dtype)
        vt_l = transform_points(scene_shard.verts.astype(dtype),
                                wvp.astype(dtype))
        nt_l = transform_normals(scene_shard.normals.astype(dtype),
                                 wv.astype(dtype))
        # scene AABB: local reduction + min/max all-reduce
        smin_l, smax_l = morton_ops.scene_aabb(vt_l)
        smin = jax.lax.pmin(smin_l, GEO_AXIS)
        smax = jax.lax.pmax(smax_l, GEO_AXIS)

        verts_t = jax.lax.all_gather(vt_l, GEO_AXIS, tiled=True)
        normals_t = jax.lax.all_gather(nt_l, GEO_AXIS, tiled=True)

        # per-face leaf stage on the LOCAL face shard (faces index the
        # gathered vertex table — OBJ indices are global)
        codes_l, lmin_l, lmax_l, _ = morton_ops.triangle_leaves(
            verts_t, scene_shard.indices, smin, smax
        )
        codes = jax.lax.all_gather(codes_l, GEO_AXIS, tiled=True)
        lmin = jax.lax.all_gather(lmin_l, GEO_AXIS, tiled=True)
        lmax = jax.lax.all_gather(lmax_l, GEO_AXIS, tiled=True)

        full = Scene(
            verts=jax.lax.all_gather(scene_shard.verts, GEO_AXIS, tiled=True),
            normals=jax.lax.all_gather(scene_shard.normals, GEO_AXIS, tiled=True),
            uv=jax.lax.all_gather(scene_shard.uv, GEO_AXIS, tiled=True),
            indices=jax.lax.all_gather(scene_shard.indices, GEO_AXIS, tiled=True),
            mat_index=jax.lax.all_gather(scene_shard.mat_index, GEO_AXIS, tiled=True),
            materials=scene_shard.materials,
            textures=scene_shard.textures,
            tex_hw=scene_shard.tex_hw,
        )
        bvh = assemble_bvh(full, verts_t, normals_t, codes, lmin, lmax, cfg)
        return _trace_tile(full, bvh, rays_tile, cfg, wvp)

    color = jax.jit(_tile)(scene, wvp, wv, rays)
    return color.reshape(cfg.height, cfg.width, 4)


def train_step_sharded(
    params,
    scene_fn,
    scene: Scene,
    camera: Camera,
    target,
    cfg: RenderConfig,
    mesh: Mesh,
    grad_chunks: int = 1,
):
    """One inverse-rendering step: returns (loss, grads) with grads
    pmean'd over every mesh axis (the distributed backward pass of
    BASELINE.md: "geometry gradients all-reduced via psum").

    Args:
      params: pytree of optimizable parameters (replicated).
      scene_fn: (params, scene) -> Scene applying params.
      target: [H, W, 4] target image (ray-sharded over rows).
      grad_chunks: > 1 splits the local ray tile into that many chunks
        and runs fwd+bwd+psum per chunk inside one ``lax.scan`` — each
        chunk's gradient all-reduce is issued while the NEXT chunk's
        backward is still computing, so XLA's latency-hiding scheduler
        overlaps collective and compute (BASELINE north star: "psum
        overlapped with the backward traversal").  Bit-equal gradients
        to grad_chunks=1 up to summation order; costs one LBVH-build
        recompute per chunk, so use it when rays dominate the step.
    """
    wvp, wv = camera_matrices(camera, cfg.width, cfg.height)
    rays = make_rays(camera, cfg)
    target_flat = target.reshape(-1, 4)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(),
            jax.tree_util.tree_map(lambda _: P(), scene),
            P(),
            P(),
            Rays(origin=P(ray_axes(mesh)), direction=P(ray_axes(mesh))),
            P(ray_axes(mesh)),
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def _step(params, scene, wvp, wv, rays_tile, target_tile):
        def chunk_grad(rays_c, target_c):
            def local_loss(p):
                s = scene_fn(p, scene)
                bvh = build_bvh(s, wvp, wv, cfg)
                color = _trace_tile(s, bvh, rays_c, cfg, wvp)
                return jnp.mean((color - target_c) ** 2)

            loss, grads = jax.value_and_grad(local_loss)(params)
            # gradient all-reduce: innermost (in-host) axes first so the
            # bulk of the ring stays on the device links; the 'dcn'
            # stage (host mesh) combines already-reduced values
            for ax in reversed(mesh.axis_names):
                grads = jax.lax.pmean(grads, ax)
                loss = jax.lax.pmean(loss, ax)
            return loss, grads

        if grad_chunks <= 1:
            return chunk_grad(rays_tile, target_tile)

        nloc = rays_tile.origin.shape[0]
        assert nloc % grad_chunks == 0, (
            f"grad_chunks {grad_chunks} must divide local rays {nloc}"
        )
        csz = nloc // grad_chunks
        rays_cs = jax.tree_util.tree_map(
            lambda x: x.reshape((grad_chunks, csz) + x.shape[1:]), rays_tile
        )
        target_cs = target_tile.reshape(grad_chunks, csz, 4)

        def body(acc, xs):
            acc_loss, acc_grads = acc
            loss, grads = chunk_grad(*xs)  # pmean INSIDE the scan step:
            # the collective for chunk i overlaps chunk i+1's backward
            acc_grads = jax.tree_util.tree_map(
                lambda a, g: a + g / grad_chunks, acc_grads, grads
            )
            return (acc_loss + loss / grad_chunks, acc_grads), None

        zero = (
            jnp.float32(0.0),
            jax.tree_util.tree_map(jnp.zeros_like, params),
        )
        (loss, grads), _ = jax.lax.scan(body, zero, (rays_cs, target_cs))
        return loss, grads

    return jax.jit(_step)(params, scene, wvp, wv, rays, target_flat)
