"""Render / build configuration.

The reference hardcodes every knob as a compile-time ``#define`` or inline
constant (reference: RayTraceGlobal.hlsl:4-11, RayTraceTraversal.hlsl:7-9,
Graphics.cpp:364,528-529,795, main.cpp:7).  Here they live in one frozen
dataclass that is hashable, so it can be passed as a static argument to
``jax.jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All static knobs of the renderer.

    Attributes:
      width/height: output resolution (reference: main.cpp:7 uses 800x800).
      bounces: number of reflection passes after the primary launch
        (reference: Graphics.cpp:795 dispatches CS_RAY_TRACE_REFLECTION 3x).
      enable_refraction: the reference allocates a refraction ray buffer but
        never dispatches the pass (reference: Graphics.cpp:805-809); we can
        actually run it.
      epsilon: Moeller-Trumbore determinant / min-distance epsilon
        (reference: RayTraceTraversal.hlsl:7, EPSILON .01).
      ray_offset: surface offset for secondary rays spawned by the primary
        launch (reference: RayTraceLaunch.hlsl:4, RAY_OFFSET .001).
      bounce_ray_offset: offset used by the reflection pass
        (reference: RayTraceReflection.hlsl:4, RAY_OFFSET .0001).
      reflection_decay / refraction_decay: intensity decay factors
        (reference: RayTraceGlobal.hlsl:10-11, both 1).
      intensity_min: bounce rays below this intensity are dead
        (reference: RayTraceGlobal.hlsl:9, INTENSITY_MIN 0).
      background: miss color (reference: RayTraceRender.hlsl:11-14).
      leaf_pad_multiple: leaves are padded to a multiple of this so shapes
        stay static across frames; the reference pads to numGrps*256
        (reference: Graphics.cpp:368,523 DATA_SIZE=256).
      ortho_scale: screen-space divisor of the reference's orthographic
        primary rays (reference: RayTraceLaunch.hlsl:23-24, the "/ 4.f").
      camera_mode: 'reference' = orthographic rays against WVP-transformed
        (clip-space, no w-divide) geometry, matching the reference exactly
        (reference: RayTraceLaunch.hlsl:23-27 + Graphics.cpp:50-53, quirks
        Q1/Q3 in SURVEY.md); 'perspective' = pinhole rays in world space.
      traversal_backend: 'auto' (the per-ray Pallas-Triton kernel,
        ops/traverse_gpu.py, on a GPU at float32; 'jnp' elsewhere),
        'jnp' (the XLA while-loop walk, ops/traverse.py; any platform) or
        'triton' (the kernel; GPU only).  pipeline.resolve_traversal_backend
        raises for an unknown name or one the platform cannot run.  'auto'
        follows jax.default_backend(): to compute on CPU arrays on a GPU
        host, ask for 'jnp'.
      sort_backend: 'lax' (one fused jax.lax.sort, the default) or 'radix'
        (the reference's 32-dispatch 1-bit LSD radix sort,
        algorithm-for-algorithm; reference: RadixSortP1/P2.hlsl).
      dtype: compute dtype for geometry / shading.
    """

    width: int = 800
    height: int = 800
    bounces: int = 3
    enable_refraction: bool = False
    # Shadow rays (BASELINE.md config 3) — a capability beyond the
    # reference, which has no lights at all (its shading is
    # ambient + diffuse*tex, RayTraceRender.hlsl:16-29).  When enabled,
    # every primary hit fires one occlusion ray at ``light_pos`` (world
    # space; transformed like the geometry in 'reference' camera mode)
    # via any-hit traversal, and the diffuse term is scaled by
    # ``shadow_factor`` when occluded.  Occlusion is discrete
    # (stop-gradient), like hit ids.
    enable_shadows: bool = False
    light_pos: Tuple[float, float, float] = (0.0, 60.0, -60.0)
    shadow_factor: float = 0.35
    epsilon: float = 0.01
    ray_offset: float = 0.001
    bounce_ray_offset: float = 0.0001
    reflection_decay: float = 1.0
    refraction_decay: float = 1.0
    intensity_min: float = 0.0
    background: Tuple[float, float, float, float] = (0.5, 0.5, 0.5, 1.0)
    leaf_pad_multiple: int = 256
    ortho_scale: float = 4.0
    camera_mode: str = "reference"
    traversal_backend: str = "auto"
    sort_backend: str = "lax"
    # 'uint8' stores the per-frame texture quad table as UNORM8 — the
    # reference's own texture format (DevIL loads 8-bit BMP/JPG,
    # Image.cpp:35-61) — quartering its memory footprint.  It kills
    # texture gradients (int cast), so the default stays float32.
    texture_dtype: str = "float32"
    max_traversal_steps: int = 0  # 0 = auto (4 * n_leaves, safe upper bound)
    # Trace rays in (ray_tile x ray_tile)-pixel tile-major order instead of
    # row-major scanline order (0 = row-major).  A block of rays in the
    # traversal kernel loops until its slowest ray is done; square pixel
    # tiles keep the block's tree paths alike — the coherence analog of the
    # reference's 15x15 threadgroup dispatch (Graphics.cpp:788-792).  Pure
    # data permutation: images are bit-identical either way.  -1 = auto
    # (pipeline.resolve_ray_tile): 8 when the traversal runs in the GPU
    # kernel, 0 for the XLA walk.
    ray_tile: int = -1
    # Tile SEQUENCE for ray_tile > 0: 'row' walks tiles along x, 'col'
    # stacks them down y first.  Pure data permutation either way
    # (reshape+transpose, no gathers); images bit-identical.
    ray_tile_order: str = "row"
    # Run the ENTIRE per-ray pipeline (launch + bounces + shading) in
    # sequential tiles of this size (0 = whole frame at once).  Bounds the
    # live per-ray state and the autodiff residuals of the differentiable
    # shading path for multi-megapixel frames.
    ray_chunk: int = 0
    # With ray_chunk > 0: traverse each chunk first and SKIP the whole
    # shade/bounce path for chunks with no primary hit (lax.cond is a
    # real scalar branch under lax.map).  Bit-identical images — an
    # all-miss chunk is provably pure background (spawn intensities 0).
    # Costs one cond per chunk on dense frames.
    cull_empty_chunks: bool = True
    dtype: str = "float32"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
