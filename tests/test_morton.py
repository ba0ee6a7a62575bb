"""Morton code kernels vs the scalar golden model.

Reference semantics: MortonCodes.hlsl:13-52; golden in ref/golden.py
follows the shader step by step.
"""

import jax.numpy as jnp
import numpy as np

from raytracebvh_tpu.ops import morton
from raytracebvh_tpu.ref import golden


def test_expand_bits_matches_scalar():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1024, 1000).astype(np.uint32)
    got = np.asarray(morton.expand_bits10(jnp.asarray(vals)))
    want = golden.expand_bits10_np(vals)
    np.testing.assert_array_equal(got, want)


def test_expand_bits_every_third_bit():
    v = morton.expand_bits10(jnp.uint32(0x3FF))
    assert int(v) == 0x09249249  # all 10 bits spread to every 3rd position


def test_morton_code_matches_scalar():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.2, 1.2, (500, 3))  # includes out-of-cube points
    got = np.asarray(morton.morton_code(jnp.asarray(pts, jnp.float32)))
    want = np.array(
        [golden.morton_scalar(p.astype(np.float32)) for p in pts], np.uint32
    )
    np.testing.assert_array_equal(got, want)


def test_morton_axis_interleave():
    # x -> bit 0, y -> bit 1, z -> bit 2 (reference: MortonCodes.hlsl:51)
    eps = 1.0 / 2048.0  # half a cell: maps to cell 0 on other axes
    x = int(morton.morton_code(jnp.array([[1.0 - eps, 0.0, 0.0]]))[0])
    y = int(morton.morton_code(jnp.array([[0.0, 1.0 - eps, 0.0]]))[0])
    z = int(morton.morton_code(jnp.array([[0.0, 0.0, 1.0 - eps]]))[0])
    assert x == 0x09249249
    assert y == 0x09249249 << 1
    assert z == 0x09249249 << 2


def test_triangle_leaves():
    rng = np.random.default_rng(2)
    verts = rng.uniform(-10, 10, (30, 3)).astype(np.float32)
    idx = np.arange(30, dtype=np.int32)
    smin, smax = verts.min(0) - 1, verts.max(0) + 1
    codes, bbmin, bbmax, cent = morton.triangle_leaves(
        jnp.asarray(verts), jnp.asarray(idx), jnp.asarray(smin), jnp.asarray(smax)
    )
    tris = verts.reshape(-1, 3, 3)
    np.testing.assert_allclose(np.asarray(bbmin), tris.min(1), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(bbmax), tris.max(1), rtol=1e-6)
    # centroid is the true mean (quirk Q2 fixed)
    np.testing.assert_allclose(np.asarray(cent), tris.mean(1), rtol=1e-5)
    want = np.array(
        [
            golden.morton_scalar(((t.mean(0) - smin) / (smax - smin)).astype(np.float32))
            for t in tris
        ],
        np.uint32,
    )
    np.testing.assert_array_equal(np.asarray(codes), want)


def test_quantize_settles_the_division_exactly():
    """The grid cell is the largest k with fl(k * extent) <= fl(1024 *
    offset), whatever the rounding of the seeding division — so CPU and
    GPU (whose f32 division is not correctly rounded) agree bit for bit."""
    rng = np.random.default_rng(5)
    ext = rng.uniform(0.5, 900.0, 4096).astype(np.float32)
    off = (rng.uniform(0, 1, 4096) * ext).astype(np.float32)
    off[:8] = ext[:8]  # the top face of the box lands in cell 1023
    got = np.asarray(morton._quantize(jnp.asarray(off), jnp.asarray(ext)))
    num = off * np.float32(1024)
    want = np.floor(num.astype(np.float64) / ext.astype(np.float64))
    for _ in range(2):  # settle with the same f32 products
        up = (want + 1).astype(np.float32) * ext <= num
        want = np.where(up, want + 1, want)
        down = want.astype(np.float32) * ext > num
        want = np.where(down, want - 1, want)
    np.testing.assert_array_equal(got, np.clip(want, 0, 1023).astype(np.uint32))
    assert (got[:8] == 1023).all()
    # a flat axis quantizes to cell 0 instead of dividing by zero
    assert int(morton._quantize(jnp.float32(0.0), jnp.float32(0.0))) == 0
