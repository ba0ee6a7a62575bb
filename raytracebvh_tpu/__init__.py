"""raytracebvh_tpu — differentiable LBVH ray tracer in JAX.

A from-scratch JAX/XLA/Pallas re-architecture of the capabilities of
Fierykev/RayTraceBVH (a DirectX 12 compute ray tracer; see SURVEY.md):
per-frame LBVH construction (30-bit morton codes, stable sort, Karras-2012
hierarchy emit, AABB fit), stackless traversal with Moeller-Trumbore
intersection, material/texture shading, and multi-bounce reflections —
plus differentiability and multi-device sharding the reference never had.
"""

import os as _os

import jax as _jax

# Persistent XLA compilation cache, so identical frame pipelines never
# compile twice across processes (the reference's analog is its
# precompiled .cso shader cache, Graphics.cpp:245-284).  JAX reads
# JAX_COMPILATION_CACHE_DIR itself; without it the cache lives at a fixed
# path inside the checkout (the path is part of the cache key).
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)
if _jax.config.jax_compilation_cache_dir is None:
    _jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)

from .config import RenderConfig
from .core.types import BVH, Camera, HitRecord, Materials, Rays, Scene
from .pipeline import build_bvh, render_frame, render_frame_jit

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "BVH",
    "Camera",
    "HitRecord",
    "Materials",
    "Rays",
    "Scene",
    "build_bvh",
    "render_frame",
    "render_frame_jit",
]
