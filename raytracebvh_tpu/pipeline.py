"""The frame pipeline: transform -> morton -> sort -> build -> trace -> shade.

This replaces the reference's command-list orchestration
(reference: Graphics.cpp:667-831 ``computeBVH`` records 40+ dispatches with
UAV barriers and a full CPU fence wait per frame).  Here the whole frame is
one jitted function; XLA's dataflow replaces every barrier and the host
never blocks mid-frame.

Differentiability: traversal returns discrete hit ids through a
``stop_gradient`` boundary; hit distances, positions, normals, uv and
colors are *recomputed* differentiably from those ids, so gradients flow to
vertices, normals, uv, materials, textures and the camera — a new
capability on top of the reference (forward-only renderer).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from .camera import (
    camera_matrices,
    perspective_rays,
    reference_rays,
    transform_normals,
    transform_points,
)
from .config import RenderConfig
from .core.types import BVH, Camera, HitRecord, Rays, Scene
from .ops import bvh as bvh_ops
from .ops import morton as morton_ops
from .ops import shade as shade_ops
from .ops import sort as sort_ops
from .ops.traverse import traverse


def _pad_count(nf: int, multiple: int) -> int:
    """Padded leaf count.  Matches the reference's sizing:
    numObjects = 256 * ceil(numIndices/256/3) (Graphics.cpp:368,523)."""
    return max(multiple, ((nf + multiple - 1) // multiple) * multiple)


def build_bvh(scene: Scene, wvp, wv, cfg: RenderConfig) -> BVH:
    """Per-frame LBVH rebuild (reference pipeline stages CS_MORTON_CODES,
    CS_RADIX_SORT_P1/P2, CS_BVH_CONSTRUCTION_P1/P2)."""
    dtype = jnp.dtype(cfg.dtype)
    verts_t = transform_points(scene.verts.astype(dtype), wvp.astype(dtype))
    normals_t = transform_normals(scene.normals.astype(dtype), wv.astype(dtype))

    smin, smax = morton_ops.scene_aabb(verts_t)
    codes, lmin, lmax, _ = morton_ops.triangle_leaves(
        verts_t, scene.indices, smin, smax
    )
    return assemble_bvh(scene, verts_t, normals_t, codes, lmin, lmax, cfg)


def assemble_bvh(scene: Scene, verts_t, normals_t, codes, lmin, lmax,
                 cfg: RenderConfig) -> BVH:
    """Sort + Karras + AABB fit + links + leaf-attr pack from per-face
    leaf data (face-id order).  Split out of ``build_bvh`` so the
    geometry-sharded path can run the leaf stage (transform + morton +
    leaf AABBs) on its shards and all-gather only the leaf arrays
    (parallel/render.render_geo_sharded)."""
    dtype = jnp.dtype(cfg.dtype)
    nf = scene.num_faces
    n = _pad_count(nf, cfg.leaf_pad_multiple)

    # pad to the static leaf count with sentinel codes + empty boxes
    pad = n - nf
    codes = jnp.concatenate(
        [codes, jnp.full(pad, morton_ops.SENTINEL_CODE, jnp.uint32)]
    )
    lmin = jnp.concatenate([lmin, jnp.full((pad, 3), bvh_ops.BIG, dtype)])
    lmax = jnp.concatenate([lmax, jnp.full((pad, 3), -bvh_ops.BIG, dtype)])
    prim = jnp.concatenate(
        [
            jnp.arange(nf, dtype=jnp.int32),
            jnp.full(pad, -1, jnp.int32),
        ]
    )

    if cfg.sort_backend == "radix":
        sorted_codes, order = sort_ops.radix_sort_by_code(codes)
    elif cfg.sort_backend == "lax":
        sorted_codes, order = sort_ops.sort_by_code(codes)
    else:
        raise ValueError(
            f"unknown sort_backend {cfg.sort_backend!r}; expected lax or radix"
        )
    # Every permutation below packs its columns into one row table,
    # gathers rows once, and slices 1-D columns back out: one gather per
    # table instead of one per column.
    # face ids ride the packed row as floats; exact only while n fits the
    # mantissa (f32: 2^24).  cfg.dtype is an unvalidated string, so guard
    # against a silent bfloat16/float16 id corruption above 256/2048.
    assert n - 1 < (1 << (jnp.finfo(dtype).nmant + 1)), (
        f"dtype {cfg.dtype} cannot represent {n} face ids exactly in the "
        "packed leaf-row gather; use float32/float64 or shrink the scene"
    )
    lrows = jnp.stack(
        [prim.astype(dtype)] + [lmin[:, k] for k in range(3)]
        + [lmax[:, k] for k in range(3)] + [jnp.zeros(n, dtype)], -1
    )[order]  # [n, 8]: one gather instead of 7
    prim = lrows[:, 0].astype(jnp.int32)  # face ids exact in f32; -1 pad
    lmin = lrows[:, 1:4]
    lmax = lrows[:, 4:7]

    topo = bvh_ops.build_topology(sorted_codes)
    bbmin, bbmax = bvh_ops.fit_aabbs(topo.node_lo, topo.node_hi, lmin, lmax)
    entry, skip = bvh_ops.compute_links(topo, n)
    child_l, child_r, parent = topo.child_l, topo.child_r, topo.parent

    # gather leaf triangle data into morton order ONCE (fixes quirk Q7,
    # the reference's per-leaf-visit WVP transform).  5 row gathers total:
    # faces [n,4], one [n,8] per corner from the packed per-vertex table,
    # one [n,16] from the packed per-material table — vs ~40 per-channel
    # 1-D gathers.
    safe_prim = jnp.maximum(prim, 0)
    frows = jnp.pad(scene.indices.reshape(-1, 3), ((0, 0), (0, 1)))
    crows = frows[safe_prim]  # [n, 4]
    corner = [crows[:, v] for v in range(3)]
    # per-vertex rows: xyz | nxnynz | uv
    vrow8 = jnp.concatenate(
        [verts_t, normals_t, scene.uv.astype(dtype)], axis=1
    )  # [nv, 8]
    A = [vrow8[corner[v]] for v in range(3)]  # 3x [n, 8]
    tri_mat = scene.mat_index[safe_prim]

    tri_verts = jnp.stack([A[v][:, 0:3] for v in range(3)], axis=1)  # [n,3,3]
    tri_normals = jnp.stack([A[v][:, 3:6] for v in range(3)], axis=1)
    tri_uv = jnp.stack([A[v][:, 6:8] for v in range(3)], axis=1)

    # packed per-leaf shading table (see core/types.py BVH.leaf_attrs)
    mats = scene.materials
    mrow16 = jnp.concatenate(
        [
            mats.ambient.astype(dtype),
            mats.diffuse.astype(dtype),
            mats.specular.astype(dtype),
            mats.shininess.astype(dtype)[:, None],
            mats.optical_density.astype(dtype)[:, None],
            mats.alpha.astype(dtype)[:, None],
            mats.tex_id.astype(dtype)[:, None],  # integer-valued float
        ],
        axis=1,
    )  # [nmat, 16]
    Am = mrow16[tri_mat]  # [n, 16]
    leaf_attrs = jnp.concatenate(
        [A[0][:, 0:3], A[1][:, 0:3], A[2][:, 0:3],
         A[0][:, 3:6], A[1][:, 3:6], A[2][:, 3:6],
         A[0][:, 6:8], A[1][:, 6:8], A[2][:, 6:8], Am],
        axis=-1,
    )  # [n, 40]

    return BVH(
        codes=sorted_codes,
        prim=prim,
        bbmin=bbmin,
        bbmax=bbmax,
        child_l=child_l,
        child_r=child_r,
        parent=parent,
        entry_link=entry,
        skip_link=skip,
        tri_verts=tri_verts,
        tri_normals=tri_normals,
        tri_uv=tri_uv,
        tri_mat=tri_mat,
        leaf_attrs=leaf_attrs,
    )


# traversal backend -> platforms it runs on
TRAVERSAL_BACKENDS = {"jnp": ("cpu", "gpu"), "triton": ("gpu",)}


def resolve_traversal_backend(cfg: RenderConfig, platform: str = None) -> str:
    """The concrete traversal backend for this config on ``platform``
    (default: JAX's default backend).

    'auto' is the per-ray Pallas-Triton kernel (ops/traverse_gpu.py) on a
    GPU at float32 and the XLA while-loop walk (ops/traverse.py)
    everywhere else.  An unknown backend, or one that cannot run on the
    platform, raises: nothing falls back silently.

    The platform is JAX's default backend, not the device the arrays sit
    on (a traced function cannot see that).  On a GPU host, a frame
    computed on CPU arrays therefore needs ``traversal_backend='jnp'``."""
    platform = platform or jax.default_backend()
    backend = cfg.traversal_backend
    if backend == "auto":
        backend = (
            "triton" if platform == "gpu" and cfg.dtype == "float32" else "jnp"
        )
    if backend not in TRAVERSAL_BACKENDS:
        raise ValueError(
            f"unknown traversal_backend {cfg.traversal_backend!r}; "
            f"expected auto or one of {sorted(TRAVERSAL_BACKENDS)}"
        )
    if platform not in TRAVERSAL_BACKENDS[backend]:
        raise ValueError(
            f"traversal_backend {backend!r} cannot run on platform "
            f"{platform!r}; it runs on {TRAVERSAL_BACKENDS[backend]}"
        )
    if backend == "triton" and cfg.dtype != "float32":
        raise ValueError(
            f"traversal_backend 'triton' is float32 only, not {cfg.dtype}"
        )
    return backend


def resolve_ray_tile(cfg: RenderConfig, platform: str = None) -> int:
    """cfg.ray_tile with -1 ('auto') resolved: 8x8-pixel tiles when the
    traversal runs in the GPU kernel, whose 128-ray blocks then loop over
    two compact tiles instead of part of one scanline; row-major (0) for
    the XLA walk, which advances the whole frame in lock-step, so the ray
    order cannot shorten it."""
    if cfg.ray_tile >= 0:
        return cfg.ray_tile
    return 8 if resolve_traversal_backend(cfg, platform) == "triton" else 0


def _traverse_ids(bvh: BVH, rays: Rays, cfg: RenderConfig) -> HitRecord:
    """Traversal with a stop_gradient boundary on the discrete outputs."""
    bvh_ng = jax.lax.stop_gradient(bvh)
    rays_ng = jax.lax.stop_gradient(rays)
    if resolve_traversal_backend(cfg) == "triton":
        from .ops.traverse_gpu import traverse_gpu

        rec = traverse_gpu(
            bvh_ng, rays_ng, cfg.epsilon, cfg.max_traversal_steps
        )
    else:
        rec = traverse(bvh_ng, rays_ng, cfg.epsilon, cfg.max_traversal_steps)
    return HitRecord(
        hit=rec.hit,
        distance=jax.lax.stop_gradient(rec.distance),
        leaf=rec.leaf,
    )


def light_in_ray_space(cfg: RenderConfig, wvp, dtype):
    """cfg.light_pos (world) -> tuple of 3 scalars in tracing space.

    'reference' camera mode traces against WVP-transformed geometry with
    no w-divide (quirks Q1/Q3), so the light rides the same transform;
    'perspective' mode traces in world space."""
    light = jnp.asarray(cfg.light_pos, dtype)
    if cfg.camera_mode == "reference":
        from .camera import transform_points

        light = transform_points(light[None], wvp.astype(dtype))[0]
    return (light[0], light[1], light[2])


def _shadow_vis(bvh: BVH, o3, d3, rec: HitRecord, light3, cfg: RenderConfig):
    """Per-ray visibility factor from one any-hit shadow ray at the
    light (BASELINE.md config 3).  Occlusion is discrete — evaluated
    entirely under stop_gradient, like the hit ids."""
    sg = jax.lax.stop_gradient
    t = sg(rec.distance)
    o3 = tuple(sg(o) for o in o3)
    d3 = tuple(sg(d) for d in d3)
    light3 = tuple(sg(l) for l in light3)
    hx = tuple(o3[i] + d3[i] * t for i in range(3))
    L = tuple(light3[i] - hx[i] for i in range(3))
    dist = jnp.sqrt(shade_ops.dot3(L, L))
    invd = 1.0 / jnp.maximum(dist, 1e-30)
    dirn = tuple(L[i] * invd for i in range(3))
    # offset along the shadow direction; cap just short of the light
    so = tuple(hx[i] + dirn[i] * cfg.ray_offset for i in range(3))
    max_t = dist * (1.0 - 1e-4)
    # dead lanes (primary misses) fire from far outside every AABB
    so = tuple(jnp.where(rec.hit, so[i], 1.0e30) for i in range(3))
    rays = _rays_of(so, dirn)

    if resolve_traversal_backend(cfg) == "triton":
        from .ops.traverse_gpu import traverse_any_gpu as any_hit
    else:
        from .ops.traverse import traverse_any as any_hit
    occ = any_hit(sg(bvh), rays, cfg.epsilon, max_t, cfg.max_traversal_steps)
    occ = occ & rec.hit
    return jnp.where(occ, jnp.asarray(cfg.shadow_factor, t.dtype), 1.0)


def _shade_hit_soa(scene: Scene, bvh: BVH, o3, d3, rec: HitRecord,
                   tex_quads=None, vis=None):
    """Differentiable re-evaluation of a hit: position, normal, surface
    color (renderPixel * specular — reference: RayTraceLaunch.hlsl:57-59)
    and per-hit material scalars.

    ONE row gather fetches everything per ray (bvh.leaf_attrs [n, 40]);
    all math then runs on 1-D component slices (structure-of-arrays)."""
    Arow = bvh.leaf_attrs[rec.leaf]  # [R, 40] — the one gather
    a = lambda k: Arow[:, k]
    t0 = (a(0), a(1), a(2))
    t1 = (a(3), a(4), a(5))
    t2 = (a(6), a(7), a(8))

    # recompute the hit distance differentiably (traversal's is
    # stop-grad): the Moeller-Trumbore distance to the plane of the hit
    # triangle (reference: RayTraceTraversal.hlsl:41-86).  Whether the ray
    # hits is traversal's decision alone: re-testing the barycentric
    # bounds here would reject an edge hit whose rounding differs from the
    # traversal's and shade it at t = -1, off the triangle.
    e1 = shade_ops.sub3(t1, t0)
    e2 = shade_ops.sub3(t2, t0)
    p = shade_ops.cross3(d3, e2)
    det = shade_ops.dot3(e1, p)
    det_ok = jnp.abs(det) >= 1e-12
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    tv = shade_ops.sub3(o3, t0)
    q = shade_ops.cross3(tv, e1)
    t = shade_ops.dot3(e2, q) * inv_det
    t = jnp.where(rec.hit, t, 0.0)
    hit_loc = tuple(o3[i] + d3[i] * t for i in range(3))

    w0, w1, w2 = shade_ops.barycentric_weights3(t0, t1, t2, hit_loc)
    n0 = (a(9), a(10), a(11))
    n1 = (a(12), a(13), a(14))
    n2 = (a(15), a(16), a(17))
    normal = tuple(
        n0[i] * w0 + n1[i] * w1 + n2[i] * w2 for i in range(3)
    )
    uvu = a(18) * w0 + a(20) * w1 + a(22) * w2
    uvv = a(19) * w0 + a(21) * w1 + a(23) * w2

    # texture sample (reference: RayTraceRender.hlsl:24-26); tex_id rides
    # channel 39 as an integer-valued float
    tex_id = a(39).astype(jnp.int32)
    hmax, wmax = scene.textures.shape[1], scene.textures.shape[2]
    if tex_quads is None:
        tex_quads = shade_ops.pack_texture_quads(scene.textures, scene.tex_hw)
    # miss lanes carry leaf-0 attrs and an arbitrary barycentric point —
    # their uv is finite garbage, and unmasked they gather RANDOM rows
    # of the quad table for pixels whose color is discarded anyway.  Pin
    # them to texel (0, 0); discreteness is fine (rec.hit is already a
    # stop-grad boundary).
    live = rec.hit
    uvu = jnp.where(live, uvu, 0.0)
    uvv = jnp.where(live, uvv, 0.0)
    tex = shade_ops.sample_texture_quads(
        tex_quads, scene.tex_hw, tex_id, uvu, uvv, hmax, wmax
    )
    # saturate(ambient + vis * diffuse * tex) * specular
    # (reference: RayTraceRender.hlsl:16-29, RayTraceLaunch.hlsl:57-59;
    # vis is the shadow-ray visibility factor, 1 when shadows are off)
    if vis is None:
        color = tuple(
            jnp.clip(a(24 + c) + a(28 + c) * tex[c], 0.0, 1.0)
            * a(32 + c)
            for c in range(4)
        )
    else:
        color = tuple(
            jnp.clip(a(24 + c) + vis * a(28 + c) * tex[c], 0.0, 1.0)
            * a(32 + c)
            for c in range(4)
        )
    shininess = a(36)
    optical = a(37)
    alpha = a(38)
    return hit_loc, normal, color, shininess, alpha, optical


def _rays_of(o3, d3):
    return Rays(
        origin=jnp.stack(o3, axis=-1), direction=jnp.stack(d3, axis=-1)
    )


def _split_rays(rays: Rays):
    o = rays.origin
    d = rays.direction
    return tuple(o[:, k] for k in range(3)), tuple(d[:, k] for k in range(3))


def _launch_soa(scene: Scene, bvh: BVH, o3, d3, cfg: RenderConfig,
                tex_quads=None, light3=None, rec=None):
    """Primary-ray pass (reference: RayTraceLaunch.hlsl), SoA form.

    Returns (color4, (refl_o3, refl_d3), refl_intensity,
    (refr_o3, refr_d3), refr_intensity) — the two RayPresent buffers the
    reference stores to u4/u5 (RayTraceGlobal.hlsl:117-118).  The
    refraction spawn follows RayTraceLaunch.hlsl:69-80 (intensity =
    (1-alpha)*REFRACTION_DECAY, origin offset *into* the surface, HLSL
    refract with eta = opticalDensity) — a pass the reference allocates
    but never dispatches (Graphics.cpp:805-809, quirk Q4); here it
    actually runs when cfg.enable_refraction.
    """
    if rec is None:
        rec = _traverse_ids(bvh, _rays_of(o3, d3), cfg)
    vis = None
    if cfg.enable_shadows and light3 is not None:
        vis = _shadow_vis(bvh, o3, d3, rec, light3, cfg)
    hit_loc, normal, hit_color, shininess, alpha, optical = _shade_hit_soa(
        scene, bvh, o3, d3, rec, tex_quads, vis
    )
    hit = rec.hit

    color = tuple(
        jnp.where(hit, hit_color[c], cfg.background[c]) for c in range(4)
    )

    # reflection spawn (reference: RayTraceLaunch.hlsl:48-67)
    intensity = jnp.where(hit, shininess / 1000.0 * cfg.reflection_decay, 0.0)
    refl_dir = shade_ops.normalize3(shade_ops.reflect3(d3, normal))
    refl_o = tuple(
        jnp.where(hit, hit_loc[i] + normal[i] * cfg.ray_offset, o3[i])
        for i in range(3)
    )
    refl_d = tuple(jnp.where(hit, refl_dir[i], d3[i]) for i in range(3))

    # refraction spawn (reference: RayTraceLaunch.hlsl:69-80)
    refr_raw = shade_ops.refract3(d3, normal, optical)
    tir = shade_ops.dot3(refr_raw, refr_raw) == 0.0  # total internal refl
    live_q = hit & ~tir
    refr_intensity = jnp.where(
        live_q, (1.0 - alpha) * cfg.refraction_decay, 0.0
    )
    refr_dir = shade_ops.normalize3(refr_raw)
    refr_o = tuple(
        jnp.where(hit, hit_loc[i] - normal[i] * cfg.ray_offset, o3[i])
        for i in range(3)
    )
    refr_d = tuple(jnp.where(live_q, refr_dir[i], d3[i]) for i in range(3))
    return color, (refl_o, refl_d), intensity, (refr_o, refr_d), refr_intensity


def launch_full(scene: Scene, bvh: BVH, rays: Rays, cfg: RenderConfig):
    """AoS adapter over _launch_soa (kept for parallel/render.py + tests)."""
    o3, d3 = _split_rays(rays)
    color, refl, ri, refr, qi = _launch_soa(scene, bvh, o3, d3, cfg)
    return (
        jnp.stack(color, axis=-1),
        _rays_of(*refl),
        ri,
        _rays_of(*refr),
        qi,
    )


def launch(scene: Scene, bvh: BVH, rays: Rays, cfg: RenderConfig):
    """Primary-ray pass, reflection outputs only (see launch_full)."""
    color, refl, intensity, _, _ = launch_full(scene, bvh, rays, cfg)
    return color, refl, intensity


def _bounce_soa(scene: Scene, bvh: BVH, color, o3, d3, intensity,
                cfg: RenderConfig, tex_quads=None):
    """One reflection pass (reference: RayTraceReflection.hlsl), SoA form.

    Live rays (intensity > INTENSITY_MIN) re-trace; hits lerp the carried
    color toward the new surface color and respawn; misses lerp toward the
    background and die.
    """
    live = intensity > cfg.intensity_min
    # dead rays traverse from far outside every AABB: they miss the root
    # box on step one instead of walking the tree (the reference skips
    # dead rays per-thread, RayTraceReflection.hlsl:17-18; lanes here are
    # batched, so "skip" = make the walk trivially short)
    o3m = tuple(jnp.where(live, o3[i], 1.0e30) for i in range(3))
    rec = _traverse_ids(bvh, _rays_of(o3m, d3), cfg)
    hit_loc, normal, hit_color, shininess, _, _ = _shade_hit_soa(
        scene, bvh, o3, d3, rec, tex_quads
    )
    hit = rec.hit & live

    new_color = tuple(
        jnp.where(
            live,
            color[c]
            + intensity * (jnp.where(hit, hit_color[c], cfg.background[c])
                           - color[c]),
            color[c],
        )
        for c in range(4)
    )

    new_intensity = jnp.where(
        live & hit, intensity * shininess / 1000.0 * cfg.reflection_decay, 0.0
    )
    new_dir = shade_ops.normalize3(shade_ops.reflect3(d3, normal))
    upd = live & hit
    new_o = tuple(
        jnp.where(upd, hit_loc[i] + normal[i] * cfg.bounce_ray_offset, o3[i])
        for i in range(3)
    )
    new_d = tuple(jnp.where(upd, new_dir[i], d3[i]) for i in range(3))
    return new_color, new_o, new_d, new_intensity


def _bounce_refract_soa(scene: Scene, bvh: BVH, color, o3, d3, intensity,
                        cfg: RenderConfig, tex_quads=None):
    """One refraction (transmission) pass — the dispatch the reference
    stubbed out (Graphics.cpp:805-809).  Mirrors ``_bounce_soa`` but
    continues *through* surfaces: same color lerp, intensity decays by the
    hit material's transparency (1-alpha), respawn offset into the surface
    with an HLSL-refract direction; total internal reflection kills the
    ray."""
    live = intensity > cfg.intensity_min
    o3m = tuple(jnp.where(live, o3[i], 1.0e30) for i in range(3))
    rec = _traverse_ids(bvh, _rays_of(o3m, d3), cfg)
    hit_loc, normal, hit_color, _, alpha, optical = _shade_hit_soa(
        scene, bvh, o3, d3, rec, tex_quads
    )
    hit = rec.hit & live

    new_color = tuple(
        jnp.where(
            live,
            color[c]
            + intensity * (jnp.where(hit, hit_color[c], cfg.background[c])
                           - color[c]),
            color[c],
        )
        for c in range(4)
    )

    refr_raw = shade_ops.refract3(d3, normal, optical)
    tir = shade_ops.dot3(refr_raw, refr_raw) == 0.0
    upd = live & hit & ~tir
    new_intensity = jnp.where(
        upd, intensity * (1.0 - alpha) * cfg.refraction_decay, 0.0
    )
    new_dir = shade_ops.normalize3(refr_raw)
    new_o = tuple(
        jnp.where(upd, hit_loc[i] - normal[i] * cfg.bounce_ray_offset, o3[i])
        for i in range(3)
    )
    new_d = tuple(jnp.where(upd, new_dir[i], d3[i]) for i in range(3))
    return new_color, new_o, new_d, new_intensity


def bounce(scene: Scene, bvh: BVH, color, rays: Rays, intensity, cfg: RenderConfig):
    """AoS adapter over _bounce_soa (kept for parallel/render.py + tests)."""
    o3, d3 = _split_rays(rays)
    c4 = tuple(color[:, c] for c in range(4))
    nc, no, nd, ni = _bounce_soa(scene, bvh, c4, o3, d3, intensity, cfg)
    return jnp.stack(nc, axis=-1), _rays_of(no, nd), ni


def bounce_refract(scene: Scene, bvh: BVH, color, rays: Rays, intensity,
                   cfg: RenderConfig):
    """AoS adapter over _bounce_refract_soa."""
    o3, d3 = _split_rays(rays)
    c4 = tuple(color[:, c] for c in range(4))
    nc, no, nd, ni = _bounce_refract_soa(scene, bvh, c4, o3, d3, intensity, cfg)
    return jnp.stack(nc, axis=-1), _rays_of(no, nd), ni


def make_rays(camera: Camera, cfg: RenderConfig) -> Rays:
    if cfg.camera_mode == "reference":
        return reference_rays(
            cfg.width, cfg.height, cfg.ortho_scale, jnp.dtype(cfg.dtype)
        )
    return perspective_rays(camera, cfg.width, cfg.height, jnp.dtype(cfg.dtype))


def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Full frame: returns [height, width, 4] float image.

    Equivalent to one iteration of the reference's onUpdate/onRender
    (Graphics.cpp:40-61,663-831): rebuild the LBVH from scratch, launch
    primary rays, run ``cfg.bounces`` reflection passes, present.
    """
    wvp, wv = camera_matrices(camera, cfg.width, cfg.height)
    if cfg.camera_mode == "reference":
        bvh = build_bvh(scene, wvp, wv, cfg)
        rays = make_rays(camera, cfg)
    else:
        # world-space tracing: identity transform
        eye4 = jnp.eye(4, dtype=jnp.dtype(cfg.dtype))
        bvh = build_bvh(scene, eye4, eye4, cfg)
        rays = make_rays(camera, cfg)

    light3 = None
    if cfg.enable_shadows:
        light3 = light_in_ray_space(cfg, wvp, jnp.dtype(cfg.dtype))
    tile = resolve_ray_tile(cfg)
    if tile > 0:
        from .camera import (
            permute_rays,
            structured_tile_shape,
            tile_order,
            tile_rays,
            untile_flat,
        )

        st = structured_tile_shape(cfg.width, cfg.height, tile)
        if st is not None:
            # reshape-based tile order: no gathers for the 10 permuted
            # columns (see camera.structured_tile_shape)
            th, tw = st
            rays = tile_rays(rays, cfg.width, cfg.height, th, tw,
                             cfg.ray_tile_order)
            color = shade_rays(scene, bvh, rays, cfg, light3)
            color = jnp.stack(
                [untile_flat(color[:, c], cfg.width, cfg.height, th, tw,
                             cfg.ray_tile_order)
                 for c in range(4)],
                axis=-1,
            )
        else:
            perm, inv = tile_order(cfg.width, cfg.height, tile)
            rays = permute_rays(rays, jnp.asarray(perm))
            color = shade_rays(scene, bvh, rays, cfg, light3)
            inv = jnp.asarray(inv)
            color = jnp.stack(
                [color[:, c][inv] for c in range(4)], axis=-1
            )
    else:
        color = shade_rays(scene, bvh, rays, cfg, light3)
    return color.reshape(cfg.height, cfg.width, 4)


def _frame_tex_quads(scene: Scene, cfg: RenderConfig):
    """One quad table per frame, shared by every pass and every ray
    chunk (see ops/shade.pack_texture_quads)."""
    tex_quads = shade_ops.pack_texture_quads(scene.textures, scene.tex_hw)
    if cfg.texture_dtype == "uint8":
        tex_quads = shade_ops.quantize_quads_u8(
            jax.lax.stop_gradient(tex_quads)
        )
    return tex_quads


def _shade_rays_one(scene: Scene, bvh: BVH, rays: Rays, cfg: RenderConfig,
                    light3=None, rec=None, tex_quads=None):
    """launch + bounce chain (+ refraction) for one batch of rays.

    Internally pure structure-of-arrays; the only [R, 4] array is the
    final stacked color.  Shadow rays (``light3`` + cfg.enable_shadows)
    apply to primary hits; bounce passes keep the reference's unshadowed
    lerp chain.  Pass ``tex_quads`` when calling per ray chunk — packed
    inside a lax.map body the full table (~100 MB on Image_Test) would
    be rebuilt per surviving chunk (XLA cannot hoist it out of the cull
    cond branch)."""
    o3, d3 = _split_rays(rays)
    if tex_quads is None:
        tex_quads = _frame_tex_quads(scene, cfg)
    color, refl, intensity, refr, refr_int = _launch_soa(
        scene, bvh, o3, d3, cfg, tex_quads, light3, rec
    )
    ro, rd = refl
    for _ in range(cfg.bounces):
        color, ro, rd, intensity = _bounce_soa(
            scene, bvh, color, ro, rd, intensity, cfg, tex_quads
        )
    if cfg.enable_refraction:
        # the refraction chain starts from a white carrier color
        # (reference: RayTraceLaunch.hlsl:70 refrRay.color = 1,1,1,1) and
        # the final present blends it over the reflection result by the
        # primary transparency — the combine the reference's PS never got
        # (it reads only reflectRay, RayTraceBVHPS.hlsl:16, quirk Q4).
        w0 = refr_int
        # chain intensity starts at 1 (the spawn transparency is applied
        # once, in the final blend), so rcolor = "the color seen through
        # the surface"; deeper transparent hits recurse with their own
        # (1-alpha) via _bounce_refract_soa.
        chain_int = jnp.where(refr_int > 0.0, jnp.ones_like(refr_int), 0.0)
        qo, qd = refr
        rcolor = tuple(jnp.ones_like(color[c]) for c in range(4))
        for _ in range(cfg.bounces):
            rcolor, qo, qd, chain_int = _bounce_refract_soa(
                scene, bvh, rcolor, qo, qd, chain_int, cfg, tex_quads
            )
        color = tuple(
            color[c] + w0 * (rcolor[c] - color[c]) for c in range(4)
        )
    return jnp.stack(color, axis=-1)


def shade_rays(scene: Scene, bvh: BVH, rays: Rays, cfg: RenderConfig,
               light3=None):
    """The whole per-ray pipeline, optionally in sequential ray tiles.

    cfg.ray_chunk > 0 runs launch+bounces tile-by-tile under ``lax.map``
    so the live per-ray state (and, under autodiff, the saved residuals)
    never exceeds one tile — the reason the reference tiles its ray
    dispatch 15x15 (Graphics.cpp:788-792) is occupancy; ours is memory:
    full-frame [R,...] temps at 1080p can exhaust device memory in the
    backward pass otherwise.
    """
    nrays = rays.origin.shape[0]
    if cfg.ray_chunk > 0 and nrays > cfg.ray_chunk:
        assert nrays % cfg.ray_chunk == 0, (
            f"ray_chunk {cfg.ray_chunk} must divide ray count {nrays}"
        )
        tiles = jax.tree_util.tree_map(
            lambda x: x.reshape(
                (nrays // cfg.ray_chunk, cfg.ray_chunk) + x.shape[1:]
            ),
            rays,
        )
        tex_quads = _frame_tex_quads(scene, cfg)
        if cfg.cull_empty_chunks:
            # Chunk-level empty culling: the whole shade/bounce path of
            # an all-miss chunk is provably pure background (spawns
            # carry zero intensity), and lax.map's per-chunk lax.cond is
            # a REAL scalar branch — so the lock-step shade math is paid
            # only by chunks that hit geometry.  The primary traversal
            # runs once here and is REUSED by the shade path (rec=).
            # Bit-identical images.
            # bg must match the shade branch's dtype exactly (lax.cond
            # requires equal branch avals): shading promotes cfg.dtype
            # by the texture table's dtype (float32 textures lift a
            # bfloat16 pipeline's color to f32)
            dt = jnp.dtype(cfg.dtype)
            if tex_quads.dtype != jnp.uint8:  # u8 samples cast to uv dtype
                dt = jnp.result_type(dt, tex_quads.dtype)
            bg = jnp.broadcast_to(
                jnp.asarray(cfg.background, dt), (cfg.ray_chunk, 4))

            def one(r):
                rec = _traverse_ids(bvh, r, cfg)
                return jax.lax.cond(
                    jnp.any(rec.hit),
                    lambda: _shade_rays_one(
                        scene, bvh, r, cfg, light3, rec, tex_quads),
                    lambda: bg,
                )

            color = jax.lax.map(one, tiles)
        else:
            color = jax.lax.map(
                lambda r: _shade_rays_one(
                    scene, bvh, r, cfg, light3, None, tex_quads),
                tiles,
            )
        return color.reshape(nrays, 4)
    return _shade_rays_one(scene, bvh, rays, cfg, light3)


@functools.partial(jax.jit, static_argnames=("cfg",))
def render_frame_jit(scene: Scene, camera: Camera, cfg: RenderConfig):
    return render_frame(scene, camera, cfg)
