"""Golden model: an independent numpy renderer with NO BVH.

Plays the role of the reference's CPU test layer (reference:
TestData.cpp:505-858 and the six CPUTests projects) — a slow, obviously
correct implementation every accelerated kernel is verified against.
Intersections are brute-force over all triangles, so agreement with the
BVH pipeline also proves the BVH returns true nearest hits.

Written against the HLSL semantics directly (Moeller-Trumbore with
EPSILON 0.01 from RayTraceTraversal.hlsl:41-86; shading from
RayTraceRender.hlsl / RayTraceHelper.hlsl; launch/bounce logic from
RayTraceLaunch.hlsl / RayTraceReflection.hlsl), with the centroid bug Q2
fixed the same way the pipeline fixes it.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------- matrices
def look_at_lh_np(eye, at, up):
    eye, at, up = (np.asarray(v, np.float64) for v in (eye, at, up))
    z = at - eye
    z /= np.linalg.norm(z)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = z
    m[3, :3] = [-x @ eye, -y @ eye, -z @ eye]
    return m


def perspective_fov_lh_np(fov_y, aspect, zn, zf):
    h = 1.0 / np.tan(fov_y / 2)
    w = h / aspect
    rng = zf / (zf - zn)
    m = np.zeros((4, 4))
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = rng
    m[2, 3] = 1.0
    m[3, 2] = -rng * zn
    return m


# ------------------------------------------------------------------ morton
def expand_bits10_np(v):
    v = np.asarray(v, np.uint32) & np.uint32(0x3FF)
    v = (v | (v << 16)) & np.uint32(0x30000FF)
    v = (v | (v << 8)) & np.uint32(0x300F00F)
    v = (v | (v << 4)) & np.uint32(0x30C30C3)
    v = (v | (v << 2)) & np.uint32(0x9249249)
    return v


def morton_scalar(p) -> int:
    """Scalar morton code of one point in the unit cube, following the
    reference kernel step by step (MortonCodes.hlsl:33-52)."""
    code = 0
    for axis in range(3):
        x = p[axis] * 1024.0
        x = min(max(x, 0.0), 1023.0)
        code |= int(expand_bits10_np(np.uint32(int(x)))) << axis
    return code


# ----------------------------------------------------------- intersection
def mt_all(origin, direction, tris, epsilon=0.01):
    """Moeller-Trumbore of rays [R,3] against all tris [F,3,3] -> [R,F]
    distances (-1 on miss)."""
    v0 = tris[:, 0][None]  # [1,F,3]
    e1 = (tris[:, 1] - tris[:, 0])[None]
    e2 = (tris[:, 2] - tris[:, 0])[None]
    d = direction[:, None]  # [R,1,3]
    o = origin[:, None]
    pvec = np.cross(d, e2)
    det = np.sum(e1 * pvec, axis=-1)
    ok = np.abs(det) >= epsilon
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tvec = o - v0
    u = np.sum(tvec * pvec, axis=-1) * inv
    qvec = np.cross(tvec, e1)
    v = np.sum(d * qvec, axis=-1) * inv
    t = np.sum(e2 * qvec, axis=-1) * inv
    ok &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > epsilon)
    return np.where(ok, t, -1.0)


def nearest_hit(origin, direction, tris, epsilon=0.01, chunk=256):
    """Brute-force nearest hit: returns (hit [R], t [R], face [R]).

    Rays go through ``mt_all`` ``chunk`` at a time, so memory stays
    [chunk, F] however many rays there are."""
    outs = []
    for s in range(0, max(len(origin), 1), chunk):
        t_all = mt_all(origin[s:s + chunk], direction[s:s + chunk], tris,
                       epsilon)
        masked = np.where(t_all > 0, t_all, np.inf)
        face = np.argmin(masked, axis=1)
        t = masked[np.arange(len(face)), face]
        hit = np.isfinite(t)
        outs.append((hit, np.where(hit, t, 0.0), face))
    return tuple(np.concatenate(x) for x in zip(*outs))


# ---------------------------------------------------------------- shading
def interp_normal_uv(tri_pos, tri_nrm, tri_uv, pt):
    v0 = tri_pos[:, 0] - pt
    v1 = tri_pos[:, 1] - pt
    v2 = tri_pos[:, 2] - pt
    a0 = np.linalg.norm(
        np.cross(tri_pos[:, 0] - tri_pos[:, 1], tri_pos[:, 0] - tri_pos[:, 2]),
        axis=-1,
    )
    a0 = np.where(a0 == 0, 1.0, a0)
    w0 = np.linalg.norm(np.cross(v1, v2), axis=-1) / a0
    w1 = np.linalg.norm(np.cross(v2, v0), axis=-1) / a0
    w2 = np.linalg.norm(np.cross(v0, v1), axis=-1) / a0
    uv = (
        tri_uv[:, 0] * w0[:, None]
        + tri_uv[:, 1] * w1[:, None]
        + tri_uv[:, 2] * w2[:, None]
    )
    nrm = (
        tri_nrm[:, 0] * w0[:, None]
        + tri_nrm[:, 1] * w1[:, None]
        + tri_nrm[:, 2] * w2[:, None]
    )
    return uv, nrm


def sample_texture_np(textures, tex_hw, tex_id, uv):
    out = np.ones(uv.shape[:-1] + (4,), np.float64)
    sel = tex_id >= 0
    if not np.any(sel):
        return out
    tid = np.where(sel, tex_id, 0)
    h = tex_hw[tid, 0].astype(np.float64)
    w = tex_hw[tid, 1].astype(np.float64)
    u = uv[..., 0] - np.floor(uv[..., 0])
    v = uv[..., 1] - np.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]

    def texel(xi, yi):
        xi = np.mod(xi.astype(np.int64), w.astype(np.int64))
        yi = np.mod(yi.astype(np.int64), h.astype(np.int64))
        return textures[tid, yi, xi]

    c = (
        texel(x0, y0) * (1 - fx) * (1 - fy)
        + texel(x0 + 1, y0) * fx * (1 - fy)
        + texel(x0, y0 + 1) * (1 - fx) * fy
        + texel(x0 + 1, y0 + 1) * fx * fy
    )
    out[sel] = c[sel]
    return out


def reflect_np(d, n):
    return d - 2.0 * np.sum(d * n, axis=-1, keepdims=True) * n


def refract_np(d, n, eta):
    """HLSL refract; zero vector on total internal reflection."""
    cosi = np.sum(d * n, axis=-1, keepdims=True)
    k = 1.0 - eta[..., None] ** 2 * (1.0 - cosi**2)
    out = eta[..., None] * d - (eta[..., None] * cosi + np.sqrt(np.maximum(k, 0.0))) * n
    return np.where(k >= 0.0, out, 0.0)


# --------------------------------------------------------------- renderer
def render_golden(scene, eye, at, up, width, height, bounces=3, ortho_scale=4.0,
                  fov=np.pi / 4, near=0.1, far=1000.0, epsilon=0.01,
                  ray_offset=0.001, bounce_ray_offset=0.0001,
                  background=(0.5, 0.5, 0.5, 1.0), refraction=False,
                  refraction_decay=1.0, shadows=False,
                  light_pos=(0.0, 60.0, -60.0), shadow_factor=0.35):
    """Brute-force render in the reference's clip-space ortho setup.

    ``scene`` is a host Scene (numpy arrays).  Returns [h, w, 4] float64.
    """
    verts = np.asarray(scene.verts, np.float64)
    nrms = np.asarray(scene.normals, np.float64)
    uv = np.asarray(scene.uv, np.float64)
    idx = np.asarray(scene.indices).reshape(-1, 3)
    matid = np.asarray(scene.mat_index)
    mats = scene.materials
    textures = np.asarray(scene.textures, np.float64)
    tex_hw = np.asarray(scene.tex_hw)

    wvp = (
        look_at_lh_np(eye, at, up)
        @ perspective_fov_lh_np(fov, height / width, near, far)
    )
    wv = look_at_lh_np(eye, at, up)
    verts_t = verts @ wvp[:3, :3] + wvp[3, :3]
    nrms_t = nrms @ wv[:3, :3]

    tris = verts_t[idx]  # [F,3,3]
    tri_nrm = nrms_t[idx]
    tri_uv = uv[idx]

    xs, ys = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    origin = np.stack(
        [
            (xs - width // 2) / ortho_scale,
            (ys - height // 2) / ortho_scale,
            np.zeros_like(xs),
        ],
        axis=-1,
    ).reshape(-1, 3).astype(np.float64)
    direction = np.tile(np.array([0.0, 0.0, 1.0]), (origin.shape[0], 1))

    background = np.asarray(background, np.float64)

    def trace_live(o, d, live):
        """nearest_hit for the live rays; dead rays report a miss (their
        results are masked out by every consumer below)."""
        hit = np.zeros(len(o), bool)
        t = np.zeros(len(o))
        face = np.zeros(len(o), np.int64)
        if live.any():
            hit[live], t[live], face[live] = nearest_hit(
                o[live], d[live], tris, epsilon)
        return hit, t, face

    def shade(o, d, hit, t, face, vis=None):
        pt = o + d * t[:, None]
        tp, tn, tu = tris[face], tri_nrm[face], tri_uv[face]
        uv_i, n_i = interp_normal_uv(tp, tn, tu, pt)
        mid = matid[face]
        tex = sample_texture_np(
            textures, tex_hw, np.asarray(mats.tex_id)[mid], uv_i
        )
        diffuse = np.asarray(mats.diffuse, np.float64)[mid] * tex
        if vis is not None:
            diffuse = vis[:, None] * diffuse
        base = np.clip(
            np.asarray(mats.ambient, np.float64)[mid] + diffuse,
            0.0,
            1.0,
        )
        color = base * np.asarray(mats.specular, np.float64)[mid]
        shin = np.asarray(mats.shininess, np.float64)[mid]
        alpha = np.asarray(mats.alpha, np.float64)[mid]
        od = np.asarray(mats.optical_density, np.float64)[mid]
        return pt, n_i, color, shin, alpha, od

    # primary launch (shadow rays on primary hits only, matching
    # pipeline._launch_soa)
    hit, t, face = nearest_hit(origin, direction, tris, epsilon)
    vis = None
    if shadows:
        light = np.asarray(light_pos, np.float64) @ wvp[:3, :3] + wvp[3, :3]
        pt0 = origin + direction * t[:, None]
        L = light[None] - pt0
        dist = np.linalg.norm(L, axis=-1)
        dirn = L / np.maximum(dist[:, None], 1e-30)
        so = pt0 + dirn * ray_offset
        t_all = mt_all(so, dirn, tris, epsilon)
        occ = np.any(
            (t_all > 0) & (t_all < (dist * (1.0 - 1e-4))[:, None]), axis=1
        )
        vis = np.where(occ & hit, shadow_factor, 1.0)
    pt, n_i, c_i, shin, alpha, od = shade(origin, direction, hit, t, face, vis)
    color = np.where(hit[:, None], c_i, background)
    intensity = np.where(hit, shin / 1000.0, 0.0)
    ro = np.where(hit[:, None], pt + n_i * ray_offset, origin)
    rd = reflect_np(direction, n_i)
    rd = rd / np.maximum(np.linalg.norm(rd, axis=-1, keepdims=True), 1e-30)
    rd = np.where(hit[:, None], rd, direction)

    if refraction:
        # refraction spawn (reference: RayTraceLaunch.hlsl:69-80, the
        # never-dispatched pass; pipeline.py launch_full mirrors this)
        qd_raw = refract_np(direction, n_i, od)
        tir = np.sum(qd_raw * qd_raw, axis=-1) == 0.0
        w0 = np.where(hit & ~tir, (1.0 - alpha) * refraction_decay, 0.0)
        qo = np.where(hit[:, None], pt - n_i * ray_offset, origin)
        qn = np.maximum(np.linalg.norm(qd_raw, axis=-1, keepdims=True), 1e-30)
        qd = np.where((hit & ~tir)[:, None], qd_raw / qn, direction)
        q_int = np.where(w0 > 0.0, 1.0, 0.0)

    for _ in range(bounces):
        live = intensity > 0.0
        hit, t, face = trace_live(ro, rd, live)
        pt, n_i, c_i, shin, _, _ = shade(ro, rd, hit, t, face)
        target = np.where(hit[:, None], c_i, background)
        lerped = color + intensity[:, None] * (target - color)
        color = np.where(live[:, None], lerped, color)
        new_int = np.where(live & hit, intensity * shin / 1000.0, 0.0)
        upd = (live & hit)[:, None]
        ro = np.where(upd, pt + n_i * bounce_ray_offset, ro)
        nd = reflect_np(rd, n_i)
        nd = nd / np.maximum(np.linalg.norm(nd, axis=-1, keepdims=True), 1e-30)
        rd = np.where(upd, nd, rd)
        intensity = new_int

    if refraction:
        rcolor = np.ones_like(color)
        for _ in range(bounces):
            live = q_int > 0.0
            hit, t, face = trace_live(qo, qd, live)
            pt, n_i, c_i, _, alpha, od = shade(qo, qd, hit, t, face)
            target = np.where(hit[:, None], c_i, background)
            lerped = rcolor + q_int[:, None] * (target - rcolor)
            rcolor = np.where(live[:, None], lerped, rcolor)
            qd_raw = refract_np(qd, n_i, od)
            tir = np.sum(qd_raw * qd_raw, axis=-1) == 0.0
            new_q = np.where(live & hit & ~tir,
                             q_int * (1.0 - alpha) * refraction_decay, 0.0)
            upd = (live & hit & ~tir)[:, None]
            qo = np.where(upd, pt - n_i * bounce_ray_offset, qo)
            qn = np.maximum(np.linalg.norm(qd_raw, axis=-1, keepdims=True), 1e-30)
            qd = np.where(upd, qd_raw / qn, qd)
            q_int = new_q
        color = color + w0[:, None] * (rcolor - color)

    return color.reshape(height, width, 4)
