"""Per-ray BVH traversal kernel for NVIDIA GPUs (Pallas, Triton route).

The reference traverses one ray per thread in 15x15-pixel threadgroups,
and idle warps retire early (reference: RayTraceTraversal.hlsl:106-193,
Graphics.cpp:788-792).  ``ops/traverse.py`` instead advances the whole
frame in lock-step under one ``while_loop``: every iteration gathers for
every ray until the deepest ray of the frame is done.  This kernel gives
each program a block of ``BLOCK`` rays, one ray per lane, and loops only
while one of *its own* rays is live, so a block of short walks finishes
early and frees its SM.

The walk is op-for-op that of ``ops/traverse.traverse`` /
``traverse_any``: the same ``entry_link``/``skip_link`` order, slab test,
Moeller-Trumbore, ``max_t`` pruning and ``max_steps`` cap (counted per
block; a live lane advances one node per iteration in both, so the cap
means the same per ray).  Node rows are packed as bbox + the two links in
one 32-byte row (links bit-cast into the float lanes), leaf rows as
v0 | e1 | e2.  float32 only.

``interpret=True`` runs the kernel in the Pallas interpreter, which is how
the CPU tests check it; the pipeline calls it only on a GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.types import BVH, HitRecord, Rays

BLOCK = 128  # rays per program: one per lane of 4 warps
NODE_W = 8  # bbmin xyz | bbmax xyz | entry | skip
LEAF_W = 12  # v0 xyz | e1 xyz | e2 xyz | pad (48-byte rows)


def pack_nodes(bvh: BVH):
    """[2n * 8] float32 node table: bbox and the two links per row."""
    links = jax.lax.bitcast_convert_type(
        jnp.stack([bvh.entry_link, bvh.skip_link], -1).astype(jnp.int32),
        jnp.float32,
    )
    return jnp.concatenate(
        [bvh.bbmin.astype(jnp.float32), bvh.bbmax.astype(jnp.float32), links],
        -1,
    ).reshape(-1)


def pack_leaves(bvh: BVH):
    """[n * 12] float32 leaf table: v0, e1 = v1 - v0, e2 = v2 - v0."""
    tv = bvh.tri_verts.astype(jnp.float32)
    v0 = tv[:, 0]
    rows = [v0, tv[:, 1] - v0, tv[:, 2] - v0, jnp.zeros_like(v0)]
    return jnp.concatenate(rows, -1).reshape(-1)


def _walk(nodes_ref, leaves_ref, o, d, inv, n, epsilon, max_steps, max_t,
          nrays):
    """The per-block loop.  Returns (leaf or -1, dist) for nearest-hit
    (``max_t is None``) or the occlusion flags for any-hit."""
    any_hit = max_t is not None
    ox, oy, oz = o
    dx, dy, dz = d
    ix, iy, iz = inv
    lane = pl.program_id(0) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    node0 = jnp.where(lane < nrays, jnp.int32(n), jnp.int32(-1))

    def col(ref, base, k, mask):
        return plgpu.load(ref.at[base + k], mask=mask, other=0.0)

    def step(node, hit, dist):
        live = node >= 0
        nb = jnp.maximum(node, 0) * NODE_W
        bminx, bminy, bminz = (col(nodes_ref, nb, k, live) for k in range(3))
        bmaxx, bmaxy, bmaxz = (col(nodes_ref, nb, k, live) for k in (3, 4, 5))
        entry = jax.lax.bitcast_convert_type(col(nodes_ref, nb, 6, live),
                                             jnp.int32)
        skip = jax.lax.bitcast_convert_type(col(nodes_ref, nb, 7, live),
                                            jnp.int32)
        t0x = (bminx - ox) * ix
        t1x = (bmaxx - ox) * ix
        t0y = (bminy - oy) * iy
        t1y = (bmaxy - oy) * iy
        t0z = (bminz - oz) * iz
        t1z = (bmaxz - oz) * iz
        tmin = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.minimum(t0z, t1z),
        )
        tmax = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.maximum(t0z, t1z),
        )
        bhit = (0.0 <= tmax) & (tmin <= tmax) & (bminx <= bmaxx) & live
        if any_hit:
            bhit = bhit & (tmin <= max_t)
        else:
            bhit = bhit & (~hit | (tmin <= dist))

        is_leaf = node < n
        at_leaf = bhit & is_leaf
        lb = jnp.where(at_leaf, node, 0) * LEAF_W
        v0x, v0y, v0z = (col(leaves_ref, lb, k, at_leaf) for k in range(3))
        e1x, e1y, e1z = (col(leaves_ref, lb, k, at_leaf) for k in (3, 4, 5))
        e2x, e2y, e2z = (col(leaves_ref, lb, k, at_leaf) for k in (6, 7, 8))
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        det_ok = jnp.abs(det) >= epsilon
        inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        u = (tvx * px + tvy * py + tvz * pz) * inv_det
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        tri_ok = (
            det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > epsilon)
        )
        found = at_leaf & tri_ok
        if any_hit:
            found = found & (t < max_t)
        else:
            found = found & (~hit | (t < dist))
        nxt = jnp.where(bhit & ~is_leaf, entry, skip)
        return nxt, found, t

    def cond(state):
        node, it = state[0], state[-1]
        return (jnp.max(node) >= 0) & (it < max_steps)

    if any_hit:
        def body(state):
            node, occ, it = state
            nxt, found, _ = step(node, occ, None)
            # an occluded lane leaves the walk at once
            node = jnp.where((node >= 0) & ~found, nxt, jnp.int32(-1))
            return node, occ | found, it + 1

        _, occ, _ = jax.lax.while_loop(
            cond, body, (node0, jnp.zeros(BLOCK, jnp.bool_), jnp.int32(0)))
        return occ

    def body(state):
        node, leaf, dist, it = state
        hit = leaf >= 0
        nxt, found, t = step(node, hit, dist)
        dist = jnp.where(found, t, dist)
        leaf = jnp.where(found, node, leaf)
        node = jnp.where(node >= 0, nxt, node)
        return node, leaf, dist, it + 1

    _, leaf, dist, _ = jax.lax.while_loop(
        cond, body,
        (node0, jnp.full(BLOCK, -1, jnp.int32), jnp.zeros(BLOCK, jnp.float32),
         jnp.int32(0)))
    return leaf, dist


def _ray_columns(rays: Rays, rpad: int):
    """Nine [R_pad] columns: origin, direction, 1/direction (computed
    by XLA, so the slab test divides exactly as ``ops/traverse.py``)."""
    o = rays.origin.astype(jnp.float32)
    d = rays.direction.astype(jnp.float32)
    inv = 1.0 / d
    cols = [o[:, k] for k in range(3)] + [d[:, k] for k in range(3)]
    cols += [inv[:, k] for k in range(3)]
    pad = rpad - o.shape[0]
    return [jnp.pad(c, (0, pad)) for c in cols]


def _call(bvh, rays, epsilon, max_steps, max_t, interpret):
    """Pads the rays to whole blocks, runs the kernel, slices the padding
    off.  Returns [leaf or -1, dist] (nearest-hit) or [occ] (any-hit)."""
    n = bvh.n_leaves
    if max_steps <= 0:
        max_steps = 4 * n
    nrays = rays.origin.shape[0]
    rpad = pl.cdiv(nrays, BLOCK) * BLOCK
    cols = _ray_columns(rays, rpad)
    any_hit = max_t is not None
    if any_hit:
        max_t = jnp.broadcast_to(jnp.asarray(max_t, jnp.float32), (nrays,))
        cols.append(jnp.pad(max_t, (0, rpad - nrays)))
        out_dtypes = [jnp.int32]
    else:
        out_dtypes = [jnp.int32, jnp.float32]

    def kernel(nodes_ref, leaves_ref, *refs):
        ins = [r[...] for r in refs[:len(cols)]]
        res = _walk(nodes_ref, leaves_ref, ins[0:3], ins[3:6], ins[6:9], n,
                    epsilon, max_steps, ins[9] if any_hit else None, nrays)
        if any_hit:
            res = (res.astype(jnp.int32),)
        for ref, val in zip(refs[len(cols):], res):
            ref[...] = val

    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    table_spec = pl.BlockSpec(memory_space=pl.ANY)
    out = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((rpad,), t) for t in out_dtypes],
        grid=(rpad // BLOCK,),
        in_specs=[table_spec, table_spec] + [ray_spec] * len(cols),
        out_specs=[ray_spec] * len(out_dtypes),
        compiler_params=plgpu.CompilerParams(num_warps=BLOCK // 32,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_traverse_any" if any_hit else "bvh_traverse",
    )(pack_nodes(bvh), pack_leaves(bvh), *cols)
    return [o[:nrays] for o in out]


@functools.partial(jax.jit, static_argnames=("epsilon", "max_steps",
                                             "interpret"))
def traverse_gpu(bvh: BVH, rays: Rays, epsilon: float, max_steps: int = 0,
                 interpret: bool = False) -> HitRecord:
    """Nearest-hit traversal; same contract as ``ops/traverse.traverse``."""
    leaf, dist = _call(bvh, rays, epsilon, max_steps, None, interpret)
    return HitRecord(hit=leaf >= 0, distance=dist.astype(rays.origin.dtype),
                     leaf=jnp.maximum(leaf, 0))


@functools.partial(jax.jit, static_argnames=("epsilon", "max_steps",
                                             "interpret"))
def traverse_any_gpu(bvh: BVH, rays: Rays, epsilon: float, max_t,
                     max_steps: int = 0, interpret: bool = False):
    """Any-hit traversal; same contract as ``ops/traverse.traverse_any``."""
    (occ,) = _call(bvh, rays, epsilon, max_steps, max_t, interpret)
    return occ > 0
