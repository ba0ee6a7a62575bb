"""Core pytree datatypes: Scene, Camera, Materials, BVH.

These replace the reference's HLSL struct declarations and D3D12 buffer
machinery (reference: RayTraceGlobal.hlsl:17-118 declares Box/Ray/Node/
Vertex/Material plus the b0/b1 cbuffers and t0-t5/u0-u5 bindings).  Here
everything is a struct-of-arrays pytree: XLA owns placement and the
"descriptor heap" is just Python attribute access.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def _pytree(cls):
    """Frozen dataclass registered as a pytree whose fields are all
    children, with a ``replace(**changes)`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[],
    )


@_pytree
class Materials:
    """Struct-of-arrays material table.

    Mirrors the fields of the reference's ``Material`` buffer struct
    (reference: RayTraceGlobal.hlsl:60-72, ObjectFileLoader.h:79-95), minus
    D3D plumbing.  ``tex_id`` is -1 for untextured materials
    (reference: RayTraceRender.hlsl:22).
    """

    ambient: Any  # [k, 4]
    diffuse: Any  # [k, 4]
    specular: Any  # [k, 4]
    shininess: Any  # [k]
    optical_density: Any  # [k]
    alpha: Any  # [k]
    tex_id: Any  # [k] int32, -1 = none

    @property
    def count(self) -> int:
        return self.ambient.shape[0]


@_pytree
class Scene:
    """Deduplicated triangle mesh + materials + textures.

    The reference uploads verts/indices/matIndices/mat as SRVs t0-t3 and up
    to MAX_TEXTURES diffuse textures as t4 (reference:
    RayTraceGlobal.hlsl:107-111, ObjectFileLoader.cpp:470-547).  Textures are
    stored here as one padded stack ``textures[T, H, W, 4]`` with per-texture
    valid extents in ``tex_hw`` so the pytree stays static-shaped.
    """

    verts: Any  # [nv, 3] float
    normals: Any  # [nv, 3] float
    uv: Any  # [nv, 2] float
    indices: Any  # [nf * 3] int32
    mat_index: Any  # [nf] int32 (per-face material)
    materials: Materials
    textures: Any  # [T, H, W, 4] float, T >= 1
    tex_hw: Any  # [T, 2] int32 valid (height, width) per texture

    @property
    def num_faces(self) -> int:
        return self.mat_index.shape[0]

    @property
    def num_verts(self) -> int:
        return self.verts.shape[0]


@_pytree
class Camera:
    """Orbit camera (reference: Graphics.h:200-203, Graphics.cpp:44-53).

    ``fov`` is the vertical field of view of XMMatrixPerspectiveFovLH;
    the reference passes aspect = height/width (reference: Graphics.cpp:46-47).
    """

    eye: Any  # [3]
    at: Any  # [3]
    up: Any  # [3]
    fov: Any  # scalar
    near: Any  # scalar
    far: Any  # scalar

    @classmethod
    def default(cls, dtype=jnp.float32) -> "Camera":
        # reference: Graphics.h:200-203 (eye (0,5,-100), at origin, +Y up)
        # and Graphics.cpp:46-47 (fov pi/4, near .1, far 1000).
        return cls(
            eye=jnp.array([0.0, 5.0, -100.0], dtype),
            at=jnp.zeros(3, dtype),
            up=jnp.array([0.0, 1.0, 0.0], dtype),
            fov=jnp.asarray(np.pi / 4, dtype),
            near=jnp.asarray(0.1, dtype),
            far=jnp.asarray(1000.0, dtype),
        )


@_pytree
class BVH:
    """Linear BVH in struct-of-arrays form.

    Node ids follow the reference's numbering (reference:
    BVHConstructP1.hlsl:152-163): leaves are ``[0, n)`` in morton-sorted
    order, internal nodes are ``[n, 2n-1)`` with the root at ``n``.  All
    per-node arrays are sized ``2n`` (slot ``2n-1`` unused) so a single
    gather serves any node id.

    Instead of the reference's 32-entry per-thread traversal stack
    (reference: RayTraceTraversal.hlsl:9,114-117) we precompute *skip links*
    (``entry_link`` = next node when the current box is hit, ``skip_link`` =
    next node when it is missed or after a leaf is tested).  Traversal then
    needs no per-lane stack at all.

    ``prim`` maps a leaf to its original face id (-1 for padding leaves;
    the reference instead leaves garbage morton codes in padding slots,
    SURVEY.md quirk Q2).  ``tri_verts``/``tri_normals``/``tri_uv``/
    ``tri_mat`` are the transformed triangle attributes gathered into leaf
    (morton) order once per build — fixing the reference's per-leaf-visit
    re-transform (reference: RayTraceTraversal.hlsl:25-35,146-148, quirk Q7).
    """

    codes: Any  # [n] uint32 sorted morton codes (sentinel for padding)
    prim: Any  # [n] int32 original face id, -1 = padding
    bbmin: Any  # [2n, 3]
    bbmax: Any  # [2n, 3]
    child_l: Any  # [2n] int32 (valid for internal ids)
    child_r: Any  # [2n] int32
    parent: Any  # [2n] int32, -1 at root
    entry_link: Any  # [2n] int32 next node on box hit
    skip_link: Any  # [2n] int32 next node on box miss / after leaf
    tri_verts: Any  # [n, 3, 3] leaf triangle vertices (ray space)
    tri_normals: Any  # [n, 3, 3]
    tri_uv: Any  # [n, 3, 2]
    tri_mat: Any  # [n] int32 material id per leaf
    # Packed per-leaf shading attributes [n, 40]: t0|t1|t2 xyz (0-8),
    # n0|n1|n2 xyz (9-17), uv0|uv1|uv2 (18-23), ambient (24-27),
    # diffuse (28-31), specular (32-35), shininess (36), optical_density
    # (37), alpha (38), tex_id as an integer-valued float (39).  One row
    # gather per shaded ray instead of ~30 per-channel gathers.
    leaf_attrs: Any  # [n, 40]

    @property
    def n_leaves(self) -> int:
        return self.codes.shape[0]

    @property
    def root(self) -> int:
        return self.n_leaves


@_pytree
class Rays:
    """A batch of rays (reference: RayTraceGlobal.hlsl:22-28)."""

    origin: Any  # [..., 3]
    direction: Any  # [..., 3]

    @property
    def inv_direction(self):
        return 1.0 / self.direction


@_pytree
class HitRecord:
    """Traversal result per ray (reference ``ColTri``,
    RayTraceGlobal.hlsl:79-85), with the triangle stored as a leaf id
    instead of 36 floats."""

    hit: Any  # [...] bool
    distance: Any  # [...] float
    leaf: Any  # [...] int32 leaf id of nearest hit (0 when ~hit)


def stack_textures(textures: list) -> tuple:
    """Pad a list of [H,W,4] float arrays into one [T,Hmax,Wmax,4] stack.

    Returns (stack, tex_hw).  With no textures, returns a 1x1 white texture
    so gathers stay in-bounds (tex_id -1 never samples it).
    """
    if not textures:
        stack = np.ones((1, 1, 1, 4), np.float32)
        return stack, np.array([[1, 1]], np.int32)
    hmax = max(t.shape[0] for t in textures)
    wmax = max(t.shape[1] for t in textures)
    out = np.zeros((len(textures), hmax, wmax, 4), np.float32)
    hw = np.zeros((len(textures), 2), np.int32)
    for i, t in enumerate(textures):
        out[i, : t.shape[0], : t.shape[1]] = t
        hw[i] = (t.shape[0], t.shape[1])
    return out, hw


def scene_to_device(scene: Scene, dtype=jnp.float32) -> Scene:
    """Move a host (numpy) scene to device arrays with the given dtype."""

    def conv(x):
        x = jnp.asarray(x)
        if jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    return jax.tree_util.tree_map(conv, scene)
