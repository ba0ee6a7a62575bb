"""Camera matrices and ray generation.

Replicates the DirectXMath row-vector conventions the reference host code
uses (reference: Graphics.cpp:44-53 builds world*view*proj with
XMMatrixLookAtLH / XMMatrixPerspectiveFovLH and uploads the transpose;
HLSL then computes ``mul(float4(p,1), M)`` which — with the transpose and
HLSL's column-major cbuffer packing — is exactly the row-vector product
``[p,1] @ WVP``).

Crucially the reference *never divides by w*: kernels take ``(float3)`` of
the 4-vector product (reference: MortonCodes.hlsl:3-7,
RayTraceTraversal.hlsl:25-35), so all tracing happens in pre-divide clip
space with orthographic primary rays (SURVEY.md quirks Q1/Q3).  We replicate
that in 'reference' camera mode and offer a conventional world-space pinhole
in 'perspective' mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .core.types import Camera, Rays

# f32 matmuls may run in TF32 on a GPU; the goldens assume true f32/f64
HIGHEST = jax.lax.Precision.HIGHEST


def look_at_lh(eye, at, up, dtype=jnp.float32):
    """Row-vector left-handed look-at, as XMMatrixLookAtLH."""
    eye = jnp.asarray(eye, dtype)
    zaxis = at - eye
    zaxis = zaxis / jnp.linalg.norm(zaxis)
    xaxis = jnp.cross(up, zaxis)
    xaxis = xaxis / jnp.linalg.norm(xaxis)
    yaxis = jnp.cross(zaxis, xaxis)
    m = jnp.stack(
        [
            jnp.array([xaxis[0], yaxis[0], zaxis[0], 0.0], dtype),
            jnp.array([xaxis[1], yaxis[1], zaxis[1], 0.0], dtype),
            jnp.array([xaxis[2], yaxis[2], zaxis[2], 0.0], dtype),
            jnp.array(
                [
                    -jnp.dot(xaxis, eye, precision=HIGHEST),
                    -jnp.dot(yaxis, eye, precision=HIGHEST),
                    -jnp.dot(zaxis, eye, precision=HIGHEST),
                    1.0,
                ],
                dtype,
            ),
        ]
    )
    return m


def perspective_fov_lh(fov_y, aspect, z_near, z_far, dtype=jnp.float32):
    """Row-vector left-handed perspective, as XMMatrixPerspectiveFovLH.

    Note the reference passes aspect = height/width
    (reference: Graphics.cpp:46-47); callers must do the same for parity.
    """
    h = 1.0 / jnp.tan(fov_y * 0.5)
    w = h / aspect
    rng = z_far / (z_far - z_near)
    z = jnp.zeros((), dtype)
    o = jnp.ones((), dtype)
    return jnp.stack(
        [
            jnp.array([w, z, z, z]),
            jnp.array([z, h, z, z]),
            jnp.array([z, z, rng, o]),
            jnp.array([z, z, -rng * z_near, z]),
        ]
    ).astype(dtype)


def camera_matrices(cam: Camera, width: int, height: int):
    """Returns (wvp, wv) row-vector matrices; world = identity
    (reference: Graphics.cpp:44-48).  Computed in the camera's dtype."""
    dtype = jnp.asarray(cam.eye).dtype
    view = look_at_lh(cam.eye, cam.at, cam.up, dtype)
    proj = perspective_fov_lh(
        cam.fov, jnp.asarray(height, dtype) / width, cam.near, cam.far, dtype
    )
    wvp = jnp.matmul(view, proj, precision=HIGHEST)
    return wvp, view


def transform_points(points, m):
    """[n,3] @ 4x4 row-vector transform, keeping xyz with NO w-divide
    (reference parity: MortonCodes.hlsl:3-7 takes (float3)mul(...)).

    Runs once per frame, replacing the reference's per-leaf-visit
    transform (quirk Q7).  Written as per-column math, not a matmul, so
    it is exact f32 on every backend."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    cols = [
        x * m[0, k] + y * m[1, k] + z * m[2, k] + m[3, k] for k in range(3)
    ]
    return jnp.stack(cols, axis=-1)


def transform_normals(normals, wv):
    """Normals by the 3x3 of worldView (reference:
    RayTraceTraversal.hlsl:30-31).  Column math (see transform_points)."""
    x, y, z = normals[:, 0], normals[:, 1], normals[:, 2]
    cols = [x * wv[0, k] + y * wv[1, k] + z * wv[2, k] for k in range(3)]
    return jnp.stack(cols, axis=-1)


def reference_rays(width: int, height: int, ortho_scale: float, dtype=jnp.float32) -> Rays:
    """The reference's orthographic primary rays in clip space
    (reference: RayTraceLaunch.hlsl:16-30): origin
    ((x - w/2)/s, (y - h/2)/s, 0), direction (0,0,1)."""
    xs = jnp.arange(width, dtype=dtype)
    ys = jnp.arange(height, dtype=dtype)
    # reference: halfWidth = screenWidth >> 1 (integer halves)
    hx = jnp.asarray(width // 2, dtype)
    hy = jnp.asarray(height // 2, dtype)
    gx, gy = jnp.meshgrid(xs, ys, indexing="xy")  # [h, w]
    origin = jnp.stack(
        [(gx - hx) / ortho_scale, (gy - hy) / ortho_scale, jnp.zeros_like(gx)],
        axis=-1,
    )
    direction = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 1.0], dtype), origin.shape
    )
    return Rays(origin=origin.reshape(-1, 3), direction=direction.reshape(-1, 3))


def tile_order(width: int, height: int, tile: int):
    """Static permutation putting rays in (tile x tile)-pixel tile-major
    order, plus its inverse.

    Rays that traverse together should be spatially coherent: a block of
    rays in the traversal kernel loops until its slowest ray is done, so
    the block's cost follows the union of its rays' tree paths.
    Row-major order puts one scanline in a block (a long skinny
    frustum); tile order packs a pixel square — a tighter path union.
    This is the ray-coherence analog of the reference's 15x15-pixel
    threadgroup dispatch (reference: Graphics.cpp:788-792).

    Returns (perm, inv) int32 numpy arrays: ``perm[i]`` is the row-major
    ray index of the i-th tile-ordered ray, and ``inv`` undoes it
    (``color_rowmajor = color_tiled[inv]``).  Computed in numpy at trace
    time — width/height/tile are static config.
    """
    import numpy as np

    idx = np.arange(width * height, dtype=np.int64).reshape(height, width)
    blocks = []
    for ty in range(0, height, tile):
        for tx in range(0, width, tile):
            blocks.append(idx[ty:ty + tile, tx:tx + tile].reshape(-1))
    perm = np.concatenate(blocks)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int64)
    return perm.astype(np.int32), inv.astype(np.int32)


def permute_rays(rays: Rays, perm) -> Rays:
    """Apply a ray permutation (one 1-D gather per column)."""
    o = rays.origin
    d = rays.direction
    return Rays(
        origin=jnp.stack([o[:, k][perm] for k in range(3)], axis=-1),
        direction=jnp.stack([d[:, k][perm] for k in range(3)], axis=-1),
    )


def structured_tile_shape(width: int, height: int, tile: int):
    """(th, tw) for the reshape-based tile path, or None.

    A tile permutation whose tile dims divide the frame is a pure
    reshape+transpose instead of 10 full-frame gathers (6 ray columns +
    4 color channels).  Prefer a square ``tile`` x ``tile``; otherwise
    halve the tile height until it divides (1080p with tile=16 -> 8x16 =
    128 px, one traversal-kernel block).
    """
    if width % tile != 0:
        return None
    th = tile
    while th > 1 and height % th != 0:
        th //= 2
    if th <= 1:
        return None
    return th, tile


def tile_flat(x, width: int, height: int, th: int, tw: int,
              order: str = "row"):
    """[height*width] row-major -> (th x tw)-tile-major, as a pure
    reshape+transpose (see structured_tile_shape).

    ``order`` sets how TILES are sequenced: 'row' walks tiles along x;
    'col' walks them down y first, so consecutive tiles stack."""
    t4 = x.reshape(height // th, th, width // tw, tw)
    if order == "col":
        return t4.transpose(2, 0, 1, 3).reshape(height * width)
    return t4.transpose(0, 2, 1, 3).reshape(height * width)


def untile_flat(x, width: int, height: int, th: int, tw: int,
                order: str = "row"):
    """Inverse of tile_flat."""
    if order == "col":
        return (
            x.reshape(width // tw, height // th, th, tw)
            .transpose(1, 2, 0, 3)
            .reshape(height * width)
        )
    return (
        x.reshape(height // th, width // tw, th, tw)
        .transpose(0, 2, 1, 3)
        .reshape(height * width)
    )


def tile_rays(rays: Rays, width: int, height: int, th: int, tw: int,
              order: str = "row") -> Rays:
    """permute_rays for the structured tile order (column-wise
    reshape+transpose, no gathers)."""
    o = rays.origin
    d = rays.direction
    tf = lambda c: tile_flat(c, width, height, th, tw, order)
    return Rays(
        origin=jnp.stack([tf(o[:, k]) for k in range(3)], axis=-1),
        direction=jnp.stack([tf(d[:, k]) for k in range(3)], axis=-1),
    )


def perspective_rays(cam: Camera, width: int, height: int, dtype=jnp.float32) -> Rays:
    """World-space pinhole rays (extension beyond the reference; its
    perspective only ever comes from the WVP applied to vertices)."""
    zaxis = cam.at - cam.eye
    zaxis = zaxis / jnp.linalg.norm(zaxis)
    xaxis = jnp.cross(cam.up, zaxis)
    xaxis = xaxis / jnp.linalg.norm(xaxis)
    yaxis = jnp.cross(zaxis, xaxis)
    tan_half = jnp.tan(cam.fov * 0.5)
    xs = (jnp.arange(width, dtype=dtype) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (jnp.arange(height, dtype=dtype) + 0.5) / height * 2.0
    gx, gy = jnp.meshgrid(xs, ys, indexing="xy")
    aspect = width / height
    d = (
        gx[..., None] * (xaxis * tan_half * aspect)
        + gy[..., None] * (yaxis * tan_half)
        + zaxis
    )
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    origin = jnp.broadcast_to(cam.eye.astype(dtype), d.shape)
    return Rays(origin=origin.reshape(-1, 3), direction=d.reshape(-1, 3))


def orbit(cam: Camera, d_yaw: float, d_pitch: float) -> Camera:
    """Rotate the eye around ``at`` (reference: Graphics.cpp:937-960 rotates
    the eye with XMMatrixRotationX/Y by +-0.1 rad on arrow keys)."""
    cy, sy = jnp.cos(d_yaw), jnp.sin(d_yaw)
    cp, sp = jnp.cos(d_pitch), jnp.sin(d_pitch)
    # row-vector rotation matrices, as XMMatrixRotationY / RotationX
    rot_y = jnp.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]], cam.eye.dtype)
    rot_x = jnp.array([[1, 0, 0], [0, cp, sp], [0, -sp, cp]], cam.eye.dtype)
    rot = jnp.matmul(rot_x, rot_y, precision=HIGHEST)
    eye = jnp.matmul(cam.eye - cam.at, rot, precision=HIGHEST) + cam.at
    return cam.replace(eye=eye)
