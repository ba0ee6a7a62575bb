"""Shading: barycentric interpolation, texture sampling, pixel color.

Replaces RayTraceRender.hlsl / RayTraceHelper.hlsl.  Everything here is
plain differentiable jnp — gradients flow to vertices, normals, uv,
material colors and textures (a capability the reference does not have).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def barycentric_normal_uv(tri_pos, tri_normal, tri_uv, point):
    """Area-ratio interpolation of normal and uv at ``point``.

    Matches getNromalTexCoord (reference: RayTraceHelper.hlsl:12-35): the
    weights are sub-triangle areas over the full triangle area.  Note the
    reference divides each sub-area by the *parallelogram* area a0 without
    halving — the ratios are identical, so we keep its exact formula.
    """
    v0 = tri_pos[..., 0, :] - point
    v1 = tri_pos[..., 1, :] - point
    v2 = tri_pos[..., 2, :] - point
    e01 = tri_pos[..., 0, :] - tri_pos[..., 1, :]
    e02 = tri_pos[..., 0, :] - tri_pos[..., 2, :]
    a0 = jnp.linalg.norm(jnp.cross(e01, e02), axis=-1)
    a0 = jnp.where(a0 == 0.0, 1.0, a0)
    w0 = jnp.linalg.norm(jnp.cross(v1, v2), axis=-1) / a0
    w1 = jnp.linalg.norm(jnp.cross(v2, v0), axis=-1) / a0
    w2 = jnp.linalg.norm(jnp.cross(v0, v1), axis=-1) / a0
    uv = (
        tri_uv[..., 0, :] * w0[..., None]
        + tri_uv[..., 1, :] * w1[..., None]
        + tri_uv[..., 2, :] * w2[..., None]
    )
    normal = (
        tri_normal[..., 0, :] * w0[..., None]
        + tri_normal[..., 1, :] * w1[..., None]
        + tri_normal[..., 2, :] * w2[..., None]
    )
    return uv, normal


def sample_texture(textures, tex_hw, tex_id, uv):
    """Bilinear sample with wrap addressing, SampleLevel(lod 0) semantics
    (reference: RayTraceRender.hlsl:24-26; sampler created at
    Image.cpp:154-169).  ``tex_id`` -1 returns white
    (reference: RayTraceRender.hlsl:19-27).

    DirectX texture space puts v=0 at the top row; OBJ vt has v=0 at the
    bottom, and the loader flips v on import (io/obj.py) to match.
    """
    tid = jnp.maximum(tex_id, 0)
    h = tex_hw[tid, 0].astype(uv.dtype)
    w = tex_hw[tid, 1].astype(uv.dtype)
    u = uv[..., 0] - jnp.floor(uv[..., 0])  # wrap
    v = uv[..., 1] - jnp.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def texel(xi, yi):
        xi = jnp.mod(xi.astype(jnp.int32), w.astype(jnp.int32))
        yi = jnp.mod(yi.astype(jnp.int32), h.astype(jnp.int32))
        return textures[tid, yi, xi]

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    color = (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )
    white = jnp.ones_like(color)
    return jnp.where((tex_id >= 0)[..., None], color, white)


def render_pixel(materials, mat_id, textures, tex_hw, uv):
    """saturate(ambient + diffuse * texColor)
    (reference: RayTraceRender.hlsl:16-29)."""
    tex_id = materials.tex_id[mat_id]
    tex_color = sample_texture(textures, tex_hw, tex_id, uv)
    color = materials.ambient[mat_id] + materials.diffuse[mat_id] * tex_color
    return jnp.clip(color, 0.0, 1.0)


def reflect(direction, normal):
    """HLSL reflect(i, n) = i - 2*dot(i, n)*n."""
    return direction - 2.0 * jnp.sum(direction * normal, axis=-1, keepdims=True) * normal


def refract(direction, normal, eta):
    """HLSL refract(i, n, eta); returns 0 on total internal reflection."""
    cosi = jnp.sum(direction * normal, axis=-1, keepdims=True)
    k = 1.0 - eta[..., None] ** 2 * (1.0 - cosi**2)
    out = eta[..., None] * direction - (eta[..., None] * cosi + jnp.sqrt(jnp.maximum(k, 0.0))) * normal
    return jnp.where(k >= 0.0, out, jnp.zeros_like(out))


def normalize(v, eps=1e-30):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), eps)


# ---------------------------------------------------------------------------
# Structure-of-arrays variants.
#
# These take and return tuples of 1-D [R] component arrays instead of
# [R, 3] / [R, 4] arrays; the math is op-for-op identical to the AoS
# versions above (same order, same primitives), so results match
# bit-for-bit, except that barycentric_weights3 signs its areas.

def cross3(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def norm3(a):
    return jnp.sqrt(dot3(a, a))


def normalize3(v, eps=1e-30):
    inv = 1.0 / jnp.maximum(norm3(v), eps)
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def reflect3(d, n):
    """HLSL reflect on components."""
    s = 2.0 * dot3(d, n)
    return (d[0] - s * n[0], d[1] - s * n[1], d[2] - s * n[2])


def refract3(d, n, eta):
    """HLSL refract on components; (0,0,0) on total internal reflection."""
    cosi = dot3(d, n)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    s = eta * cosi + jnp.sqrt(jnp.maximum(k, 0.0))
    ok = k >= 0.0
    return tuple(jnp.where(ok, eta * d[i] - s * n[i], 0.0) for i in range(3))


def barycentric_weights3(tri0, tri1, tri2, point):
    """Area-ratio weights (w0, w1, w2) at ``point``; components in,
    components out (reference: RayTraceHelper.hlsl:12-35).

    The sub-triangle areas are signed (projected on the triangle's
    normal) where the reference takes their lengths.  Inside the triangle
    the two agree.  On an edge a length has no gradient, and just outside
    one (where a hit lands when the traversal's rounding accepts it) it
    folds back and its gradient flips sign; the signed area goes on
    smoothly.  With lengths, two programs that round differently gave
    vertex gradients further apart than the gradient's own norm."""
    v0 = sub3(tri0, point)
    v1 = sub3(tri1, point)
    v2 = sub3(tri2, point)
    n = cross3(sub3(tri0, tri1), sub3(tri0, tri2))
    nn = dot3(n, n)
    nn = jnp.where(nn == 0.0, 1.0, nn)
    w0 = dot3(cross3(v1, v2), n) / nn
    w1 = dot3(cross3(v2, v0), n) / nn
    w2 = dot3(cross3(v0, v1), n) / nn
    return w0, w1, w2


def _texel_dims(tex_hw, tid, dtype):
    """Per-ray texture (h, w) WITHOUT per-row gathers where possible.

    Single-texture scenes broadcast scalars instead of two R-row gathers
    into the [T, 2] table; multi-texture scenes pay ONE packed [R, 2] row
    gather."""
    if tex_hw.shape[0] == 1:
        return (jnp.asarray(tex_hw[0, 0], dtype),
                jnp.asarray(tex_hw[0, 1], dtype))
    hw = tex_hw[tid]  # [R, 2] — one row gather
    return hw[:, 0].astype(dtype), hw[:, 1].astype(dtype)


def sample_texture_planes(tex_planes, tex_hw, tex_id, u, v):
    """Bilinear wrap sample from channel-split texture planes.

    tex_planes: tuple of 4 [T, H, W] arrays (the channel-major form of
    the [T, H, W, 4] stack).  Returns a 4-tuple of [R] channels;
    tex_id -1 samples white.
    """
    tid = jnp.maximum(tex_id, 0)
    h, w = _texel_dims(tex_hw, tid, u.dtype)
    uu = u - jnp.floor(u)
    vv = v - jnp.floor(v)
    x = uu * w - 0.5
    y = vv * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    wi = w.astype(jnp.int32)
    hi = h.astype(jnp.int32)

    def idx(xi, yi):
        return tid, jnp.mod(yi.astype(jnp.int32), hi), jnp.mod(
            xi.astype(jnp.int32), wi
        )

    i00 = idx(x0, y0)
    i10 = idx(x0 + 1, y0)
    i01 = idx(x0, y0 + 1)
    i11 = idx(x0 + 1, y0 + 1)
    has_tex = tex_id >= 0
    out = []
    for p in tex_planes:
        c = (
            p[i00] * (1 - fx) * (1 - fy)
            + p[i10] * fx * (1 - fy)
            + p[i01] * (1 - fx) * fy
            + p[i11] * fx * fy
        )
        out.append(jnp.where(has_tex, c, jnp.ones_like(c)))
    return tuple(out)


def sample_texture_rows(tex_flat, tex_hw, tex_id, u, v, hmax, wmax):
    """Bilinear wrap sample via 4 row gathers from the flattened stack.

    tex_flat: [T*hmax*wmax, 4] (= textures.reshape(-1, 4), a free
    reshape).  One [R, 4] row gather per texel corner instead of 16
    per-channel gathers.  Returns a 4-tuple of [R] channels; tex_id -1 samples white.  Values
    identical to sample_texture / sample_texture_planes.
    """
    tid = jnp.maximum(tex_id, 0)
    h, w = _texel_dims(tex_hw, tid, u.dtype)
    uu = u - jnp.floor(u)
    vv = v - jnp.floor(v)
    x = uu * w - 0.5
    y = vv * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    wi = w.astype(jnp.int32)
    hi = h.astype(jnp.int32)
    base = tid * (hmax * wmax)

    def fetch(xi, yi):
        flat = base + jnp.mod(yi.astype(jnp.int32), hi) * wmax + jnp.mod(
            xi.astype(jnp.int32), wi
        )
        return tex_flat[flat]  # [R, 4]

    r00 = fetch(x0, y0)
    r10 = fetch(x0 + 1, y0)
    r01 = fetch(x0, y0 + 1)
    r11 = fetch(x0 + 1, y0 + 1)
    has_tex = tex_id >= 0
    out = []
    for c in range(4):
        col = (
            r00[:, c] * (1 - fx) * (1 - fy)
            + r10[:, c] * fx * (1 - fy)
            + r01[:, c] * (1 - fx) * fy
            + r11[:, c] * fx * fy
        )
        out.append(jnp.where(has_tex, col, jnp.ones_like(col)))
    return tuple(out)


def pack_texture_quads(textures, tex_hw):
    """[T, H, W, 4] -> [T*H*W, 16] where row (t, y, x) holds the 2x2
    wrap-neighborhood {(y,x), (y,x+1), (y+1,x), (y+1,x+1)} RGBA-major.

    Bilinear sampling then needs ONE [R, 16] row gather per sample instead
    of four corner gathers.  The pack itself is rolls + a reshape —
    bandwidth-trivial, differentiable
    (texture training grads flow through it), and done once per frame.

    Textures smaller than the padded stack wrap at their TRUE size
    (tex_hw), so before rolling, each texture's wrap column/row is copied
    into the first padding column/row; a texture filling the stack wraps
    via the roll itself."""
    t, h, w, c = textures.shape
    ht = tex_hw[:, 0].astype(jnp.int32)[:, None, None, None]
    wt = tex_hw[:, 1].astype(jnp.int32)[:, None, None, None]
    col = jax.lax.broadcasted_iota(jnp.int32, (t, h, w, c), 2)
    row = jax.lax.broadcasted_iota(jnp.int32, (t, h, w, c), 1)
    # column w_t := column 0, then row h_t := (column-fixed) row 0 — the
    # second copy also lands the (h_t, w_t) corner texel
    fixed = jnp.where(col == wt, textures[:, :, 0:1, :], textures)
    fixed = jnp.where(row == ht, fixed[:, 0:1, :, :], fixed)
    x1 = jnp.roll(fixed, -1, axis=2)
    y1 = jnp.roll(fixed, -1, axis=1)
    xy1 = jnp.roll(x1, -1, axis=1)
    quads = jnp.concatenate([fixed, x1, y1, xy1], axis=-1)  # [T,H,W,16]
    return quads.reshape(t * h * w, 4 * c)


def quantize_quads_u8(tex_quads):
    """[*, 16] float quads in [0,1] -> uint8 (UNORM8).

    The reference's textures ARE 8-bit UNORM (BMP/JPG via DevIL,
    Image.cpp:35-61; the sampler reads UNORM8), so for 8-bit-sourced
    textures this is bit-exact with the float path (k/255 -> k -> k/255)
    while the per-ray quad gather moves 16 bytes instead of 64.
    Not differentiable (int cast); use texture_dtype='float32' to train
    textures."""
    return jnp.round(tex_quads * 255.0).astype(jnp.uint8)


def sample_texture_quads(tex_quads, tex_hw, tex_id, u, v, hmax, wmax):
    """Bilinear wrap sample via ONE row gather from pack_texture_quads.

    Semantics identical to sample_texture_rows (DirectX SampleLevel-0 with
    wrap addressing, reference: RayTraceRender.hlsl:24-26, sampler
    Image.cpp:154-169); tex_id -1 samples white.  The u-floor(u) wrap puts
    x0 = floor(u*w - .5) in [-1, w-1], so wrap needs only a select, not an
    integer mod."""
    tid = jnp.maximum(tex_id, 0)
    h, w = _texel_dims(tex_hw, tid, u.dtype)
    uu = u - jnp.floor(u)
    vv = v - jnp.floor(v)
    x = uu * w - 0.5
    y = vv * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    xi = x0.astype(jnp.int32)
    yi = y0.astype(jnp.int32)
    xi = jnp.where(xi < 0, xi + w.astype(jnp.int32), xi)
    yi = jnp.where(yi < 0, yi + h.astype(jnp.int32), yi)
    flat = (tid * hmax + yi) * wmax + xi
    q = tex_quads[flat]  # [R, 16] — the one gather
    if q.dtype == jnp.uint8:  # UNORM8 path (see quantize_quads_u8)
        q = q.astype(u.dtype) / 255.0
    qc = lambda k: q[:, k]
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    has_tex = tex_id >= 0
    out = []
    for c in range(4):
        col = (
            qc(c) * w00
            + qc(4 + c) * w10
            + qc(8 + c) * w01
            + qc(12 + c) * w11
        )
        out.append(jnp.where(has_tex, col, jnp.ones_like(col)))
    return tuple(out)


def render_pixel3(materials, mat_id, tex_planes, tex_hw, u, v):
    """saturate(ambient + diffuse * texColor) per channel
    (reference: RayTraceRender.hlsl:16-29).  Returns a 4-tuple of [R]."""
    tex_id = materials.tex_id[mat_id]
    tex = sample_texture_planes(tex_planes, tex_hw, tex_id, u, v)
    out = []
    for c in range(4):
        amb = materials.ambient[:, c][mat_id]
        dif = materials.diffuse[:, c][mat_id]
        out.append(jnp.clip(amb + dif * tex[c], 0.0, 1.0))
    return tuple(out)
