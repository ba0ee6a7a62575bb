"""30-bit Morton codes for triangle centroids.

Vectorized over all triangles at once (the reference runs 128-thread groups
with a load factor of 2; reference: MortonCodes.hlsl:54-124).  The centroid
is the true average of the three transformed vertices — the reference has a
copy-paste bug (``avg = minUnion(bbMin, vertData)``, MortonCodes.hlsl:98)
that its own CPU golden model corrects (TestData.cpp:557); we implement the
correct semantics (SURVEY.md quirk Q2).
"""

from __future__ import annotations

import jax.numpy as jnp

# Sentinel code for padding leaves: all 30 payload bits set, so padding
# sorts after every real leaf.  The reference instead leaves garbage in
# padding slots (quirk Q2).
SENTINEL_CODE = jnp.uint32(0x3FFFFFFF)


def expand_bits10(v):
    """Spread the low 10 bits of each lane to every 3rd bit.

    Same byte-mask cascade as the reference (MortonCodes.hlsl:13-31,
    masks {0x09249249, 0x030c30c3, 0x0300f00f, 0x030000ff, 0x000003ff}).
    """
    v = v.astype(jnp.uint32) & jnp.uint32(0x000003FF)
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


def morton_code(p):
    """[..., 3] points in the unit cube -> [...] uint32 codes.

    Reference semantics (MortonCodes.hlsl:33-52): scale by 1024, clamp to
    [0, 1023], truncate, interleave as x | y<<1 | z<<2.
    """
    scaled = jnp.clip(p * 1024.0, 0.0, 1023.0).astype(jnp.uint32)
    ex = expand_bits10(scaled[..., 0])
    ey = expand_bits10(scaled[..., 1])
    ez = expand_bits10(scaled[..., 2])
    return ex | (ey << 1) | (ez << 2)


def _quantize(offset, extent):
    """floor(1024 * offset / extent) clamped to [0, 1023] — the grid cell
    of MortonCodes.hlsl — computed so that every backend returns the same
    integer.  A GPU's f32 division is not correctly rounded, so the
    division only seeds the answer; the largest k with
    fl(k * extent) <= fl(1024 * offset) is then settled by products and
    compares, which round the same everywhere (the seed is within one of
    it).  No product here feeds an add, so no backend can contract one
    into a fused multiply-add."""
    extent = jnp.where(extent > 0, extent, 1.0)  # flat axis: cell 0
    num = offset * 1024.0
    q = jnp.floor(num / extent)
    q = jnp.where((q + 1.0) * extent <= num, q + 1.0, q)
    q = jnp.where(q * extent > num, q - 1.0, q)
    return jnp.clip(q, 0.0, 1023.0).astype(jnp.uint32)


def triangle_leaves(verts_t, indices, scene_min, scene_max):
    """Per-triangle morton codes and AABBs from transformed vertices.

    Args:
      verts_t: [nv, 3] ray-space vertex positions (already WVP-transformed;
        the reference transforms inside the kernel, MortonCodes.hlsl:3-7).
      indices: [nf*3] int32.
      scene_min/scene_max: [3] scene AABB in ray space.  The reference
        hardcodes +-700 (Graphics.cpp:528-529, quirk Q6); the pipeline
        computes the real AABB by reduction.

    Returns:
      codes [nf] uint32, bbmin [nf,3], bbmax [nf,3], centroid [nf,3].
    """
    # Row-gather layout: the vertex table is padded to 4-wide rows and
    # each corner is ONE row gather ([nf, 4]) — 3 gathers total instead of
    # 9 per-coordinate 1-D gathers.  All math then runs on 1-D column
    # slices of the gathered rows.
    i0, i1, i2 = indices[0::3], indices[1::3], indices[2::3]
    vrows = jnp.pad(verts_t, ((0, 0), (0, 1)))  # [nv, 4]
    r0, r1, r2 = vrows[i0], vrows[i1], vrows[i2]  # [nf, 4] each
    mins, maxs, cens, scaled = [], [], [], []
    for k in range(3):
        c0, c1, c2 = r0[:, k], r1[:, k], r2[:, k]
        mins.append(jnp.minimum(jnp.minimum(c0, c1), c2))
        maxs.append(jnp.maximum(jnp.maximum(c0, c1), c2))
        cens.append((c0 + c1 + c2) / 3.0)
        # the centroid's cell, from 3x its offset to the box corner: sums
        # of differences only, so the centroid's division by 3 (a product
        # after XLA's rewrite) cannot contract into a multiply-add on one
        # backend and not on another
        lo = scene_min[k]
        off3 = (c0 - lo) + (c1 - lo) + (c2 - lo)
        scaled.append(_quantize(off3, (scene_max[k] - lo) * 3.0))
    codes = (
        expand_bits10(scaled[0])
        | (expand_bits10(scaled[1]) << 1)
        | (expand_bits10(scaled[2]) << 2)
    )
    bbmin = jnp.stack(mins, -1)
    bbmax = jnp.stack(maxs, -1)
    centroid = jnp.stack(cens, -1)
    return codes, bbmin, bbmax, centroid


def scene_aabb(verts_t):
    """Scene AABB by reduction — the capability the reference abandoned
    (RayTraceBVHCST.hlsl was dead code; it hardcoded +-700 instead,
    Graphics.cpp:528-529)."""
    return jnp.min(verts_t, axis=0), jnp.max(verts_t, axis=0)
