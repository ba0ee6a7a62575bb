"""Batched stackless BVH traversal with Moeller-Trumbore intersection.

The reference traverses with a per-thread 32-entry stack and a DFS loop
(reference: RayTraceTraversal.hlsl:106-193), re-transforming every leaf's
three vertices by WVP on *every visit* (RayTraceTraversal.hlsl:146-148,
quirk Q7).  In batched array code both choices are wrong: per-lane stacks
need dynamic per-lane indexing (scatter/gather into scratch) and the
re-transform wastes bandwidth.

Array design: all rays advance in lock-step through precomputed skip
links (see ops/bvh.py).  Each step is, for every live ray, a handful of
gathers by node id plus pure vector math:

    box hit & internal  -> entry_link (descend left-first)
    box hit & leaf      -> Moeller-Trumbore against the leaf triangle
                           (pre-gathered into leaf order), then skip_link
    box miss            -> skip_link (prune the subtree)

The visit order equals the reference's stack DFS whenever both children
are hit; only the "right-only" case costs one extra box test.  Rays finish
when they walk off the root's skip link (-1); finished lanes idle at node
-1 until the batch drains.  This is the plain reference walk and the CPU
path; ops/traverse_gpu.py is the same walk as a per-ray GPU kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import BVH, HitRecord, Rays


def ray_box_hit(origin, inv_dir, bbmin, bbmax, has_hit, best_t):
    """Slab test (reference: RayTraceTraversal.hlsl:92-104), plus an
    explicit empty-box rejection (bbmin > bbmax) for padding leaves — the
    reference instead traverses garbage boxes (quirk Q2)."""
    dmin = (bbmin - origin) * inv_dir
    dmax = (bbmax - origin) * inv_dir
    lo = jnp.minimum(dmin, dmax)
    hi = jnp.maximum(dmin, dmax)
    tmin = jnp.max(lo, axis=-1)
    tmax = jnp.min(hi, axis=-1)
    nonempty = jnp.all(bbmin <= bbmax, axis=-1)
    hit = (0.0 <= tmax) & (tmin <= tmax) & nonempty
    # prune against the current nearest hit (reference: ...hlsl:103)
    return hit & (~has_hit | (tmin <= best_t))


def moller_trumbore(origin, direction, v0, v1, v2, epsilon):
    """Moeller-Trumbore (reference: RayTraceTraversal.hlsl:41-86).

    Returns distance, or -1 on miss — exactly the reference's contract,
    including the EPSILON determinant cutoff and min-distance.
    """
    edge1 = v1 - v0
    edge2 = v2 - v0
    pvec = jnp.cross(direction, edge2)
    det = jnp.sum(edge1 * pvec, axis=-1)
    # no-determinant cutoff (reference: :50-51)
    det_ok = jnp.abs(det) >= epsilon
    inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    tvec = origin - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, edge1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    t = jnp.sum(edge2 * qvec, axis=-1) * inv_det
    ok = (
        det_ok
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > epsilon)
    )
    return jnp.where(ok, t, -1.0)


def traverse(bvh: BVH, rays: Rays, epsilon: float, max_steps: int = 0) -> HitRecord:
    """Nearest-hit traversal for a batch of rays.

    Args:
      bvh: built BVH (ops/bvh.py) with leaf triangles pre-gathered.
      rays: [R] rays (flat).
      epsilon: Moeller-Trumbore epsilon (reference EPSILON .01).
      max_steps: safety cap on traversal steps (0 = 4n, an upper bound on
        skip-walk length: every node is entered at most once plus once
        skipped).

    Returns HitRecord with leaf ids into the BVH's leaf arrays
    (reference stores index/3 = face id in ColTri,
    RayTraceTraversal.hlsl:157; recover it as ``bvh.prim[leaf]``).

    Layout note: everything inside the hot loop is 1-D component arrays
    (structure-of-arrays).
    """
    n = bvh.n_leaves
    root = jnp.int32(n)
    nrays = rays.origin.shape[0]
    if max_steps <= 0:
        max_steps = 4 * n

    # split every gathered table into 1-D component arrays (see note)
    ox, oy, oz = (rays.origin[:, k] for k in range(3))
    dx, dy, dz = (rays.direction[:, k] for k in range(3))
    inv = rays.inv_direction
    ix, iy, iz = (inv[:, k] for k in range(3))
    bminx, bminy, bminz = (bvh.bbmin[:, k] for k in range(3))
    bmaxx, bmaxy, bmaxz = (bvh.bbmax[:, k] for k in range(3))
    tv = bvh.tri_verts  # [n, 3, 3]
    v0x, v0y, v0z = (tv[:, 0, k] for k in range(3))
    # precompute edges once per build (the reference re-derives them from
    # re-transformed vertices on every leaf visit, quirk Q7)
    e1x, e1y, e1z = (tv[:, 1, k] - tv[:, 0, k] for k in range(3))
    e2x, e2y, e2z = (tv[:, 2, k] - tv[:, 0, k] for k in range(3))
    entry_link = bvh.entry_link
    skip_link = bvh.skip_link

    def cond(state):
        node, _, _, _, it = state
        return jnp.any(node >= 0) & (it < max_steps)

    def body(state):
        node, hit, dist, leaf, it = state
        live = node >= 0
        nid = jnp.maximum(node, 0)

        # slab test (reference: RayTraceTraversal.hlsl:92-104); empty
        # padding boxes (bbmin > bbmax) can never pass
        t0x = (bminx[nid] - ox) * ix
        t1x = (bmaxx[nid] - ox) * ix
        t0y = (bminy[nid] - oy) * iy
        t1y = (bmaxy[nid] - oy) * iy
        t0z = (bminz[nid] - oz) * iz
        t1z = (bmaxz[nid] - oz) * iz
        tmin = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.minimum(t0z, t1z),
        )
        tmax = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.maximum(t0z, t1z),
        )
        nonempty = bminx[nid] <= bmaxx[nid]
        bhit = (0.0 <= tmax) & (tmin <= tmax) & nonempty
        bhit = bhit & (~hit | (tmin <= dist)) & live

        is_leaf = nid < n
        # leaf triangle test, Moeller-Trumbore on components
        # (reference: RayTraceTraversal.hlsl:41-86; masked — padding
        # leaves have empty boxes so bhit already excludes them)
        lid = jnp.where(is_leaf, nid, 0)
        g_v0x, g_v0y, g_v0z = v0x[lid], v0y[lid], v0z[lid]
        g_e1x, g_e1y, g_e1z = e1x[lid], e1y[lid], e1z[lid]
        g_e2x, g_e2y, g_e2z = e2x[lid], e2y[lid], e2z[lid]
        px = dy * g_e2z - dz * g_e2y
        py = dz * g_e2x - dx * g_e2z
        pz = dx * g_e2y - dy * g_e2x
        det = g_e1x * px + g_e1y * py + g_e1z * pz
        det_ok = jnp.abs(det) >= epsilon
        inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
        tvx, tvy, tvz = ox - g_v0x, oy - g_v0y, oz - g_v0z
        u = (tvx * px + tvy * py + tvz * pz) * inv_det
        qx = tvy * g_e1z - tvz * g_e1y
        qy = tvz * g_e1x - tvx * g_e1z
        qz = tvx * g_e1y - tvy * g_e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (g_e2x * qx + g_e2y * qy + g_e2z * qz) * inv_det
        tri_ok = (
            det_ok
            & (u >= 0.0)
            & (u <= 1.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > epsilon)
        )

        upd = live & is_leaf & bhit & tri_ok & (~hit | (t < dist))
        dist = jnp.where(upd, t, dist)
        leaf = jnp.where(upd, nid, leaf)
        hit = hit | upd

        descend = bhit & ~is_leaf
        nxt = jnp.where(descend, entry_link[nid], skip_link[nid])
        node = jnp.where(live, nxt, node)
        return node, hit, dist, leaf, it + 1

    state = (
        jnp.full(nrays, root, jnp.int32),
        jnp.zeros(nrays, bool),
        jnp.zeros(nrays, rays.origin.dtype),
        jnp.zeros(nrays, jnp.int32),
        jnp.int32(0),
    )
    _, hit, dist, leaf, _ = jax.lax.while_loop(cond, body, state)
    return HitRecord(hit=hit, distance=dist, leaf=leaf)


def traverse_any(bvh: BVH, rays: Rays, epsilon: float, max_t,
                 max_steps: int = 0):
    """Any-hit (occlusion) traversal: True where ANY triangle intersects
    the ray at distance in (epsilon, max_t).

    A strict simplification of ``traverse`` (reference traversal loop:
    RayTraceTraversal.hlsl:106-193): no nearest-hit bookkeeping, and a
    lane exits the walk the moment it finds any occluder.  Used for
    shadow rays (BASELINE.md config 3 — the reference has no lights).

    Args:
      max_t: [R] maximum hit distance (e.g. distance to the light).
    """
    n = bvh.n_leaves
    nrays = rays.origin.shape[0]
    if max_steps <= 0:
        max_steps = 4 * n

    ox, oy, oz = (rays.origin[:, k] for k in range(3))
    dx, dy, dz = (rays.direction[:, k] for k in range(3))
    inv = rays.inv_direction
    ix, iy, iz = (inv[:, k] for k in range(3))
    bminx, bminy, bminz = (bvh.bbmin[:, k] for k in range(3))
    bmaxx, bmaxy, bmaxz = (bvh.bbmax[:, k] for k in range(3))
    tv = bvh.tri_verts
    v0x, v0y, v0z = (tv[:, 0, k] for k in range(3))
    e1x, e1y, e1z = (tv[:, 1, k] - tv[:, 0, k] for k in range(3))
    e2x, e2y, e2z = (tv[:, 2, k] - tv[:, 0, k] for k in range(3))
    entry_link = bvh.entry_link
    skip_link = bvh.skip_link

    def cond(state):
        node, _, it = state
        return jnp.any(node >= 0) & (it < max_steps)

    def body(state):
        node, occ, it = state
        live = node >= 0
        nid = jnp.maximum(node, 0)

        t0x = (bminx[nid] - ox) * ix
        t1x = (bmaxx[nid] - ox) * ix
        t0y = (bminy[nid] - oy) * iy
        t1y = (bmaxy[nid] - oy) * iy
        t0z = (bminz[nid] - oz) * iz
        t1z = (bmaxz[nid] - oz) * iz
        tmin = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.minimum(t0z, t1z),
        )
        tmax = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.maximum(t0z, t1z),
        )
        nonempty = bminx[nid] <= bmaxx[nid]
        # prune boxes entirely beyond the light distance
        bhit = (0.0 <= tmax) & (tmin <= tmax) & nonempty & (tmin <= max_t) & live

        is_leaf = nid < n
        lid = jnp.where(is_leaf, nid, 0)
        g_v0x, g_v0y, g_v0z = v0x[lid], v0y[lid], v0z[lid]
        g_e1x, g_e1y, g_e1z = e1x[lid], e1y[lid], e1z[lid]
        g_e2x, g_e2y, g_e2z = e2x[lid], e2y[lid], e2z[lid]
        px = dy * g_e2z - dz * g_e2y
        py = dz * g_e2x - dx * g_e2z
        pz = dx * g_e2y - dy * g_e2x
        det = g_e1x * px + g_e1y * py + g_e1z * pz
        det_ok = jnp.abs(det) >= epsilon
        inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
        tvx, tvy, tvz = ox - g_v0x, oy - g_v0y, oz - g_v0z
        u = (tvx * px + tvy * py + tvz * pz) * inv_det
        qx = tvy * g_e1z - tvz * g_e1y
        qy = tvz * g_e1x - tvx * g_e1z
        qz = tvx * g_e1y - tvy * g_e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (g_e2x * qx + g_e2y * qy + g_e2z * qz) * inv_det
        tri_ok = (
            det_ok
            & (u >= 0.0)
            & (u <= 1.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > epsilon)
            & (t < max_t)
        )

        found = live & is_leaf & bhit & tri_ok
        occ = occ | found

        descend = bhit & ~is_leaf
        nxt = jnp.where(descend, entry_link[nid], skip_link[nid])
        # occluded lanes exit the walk immediately (any-hit early out)
        node = jnp.where(live & ~found, nxt, jnp.int32(-1))
        return node, occ, it + 1

    state = (
        jnp.full(nrays, jnp.int32(n)),
        jnp.zeros(nrays, bool),
        jnp.int32(0),
    )
    _, occ, _ = jax.lax.while_loop(cond, body, state)
    return occ
