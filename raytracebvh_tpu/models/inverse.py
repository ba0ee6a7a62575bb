"""Inverse rendering: the framework's flagship differentiable "model".

Optimizes scene parameters (vertex offsets, material colors) so the
rendered image matches a target — the capability BASELINE.md mandates on
top of the reference's forward-only pipeline ("backward pass for
vertex/material grads").  The training step is the unit the multi-chip
dry-run shards: rays data-parallel, geometry all-gathered, gradients
psum'd.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from ..config import RenderConfig
from ..core.types import Camera, Scene
from ..pipeline import render_frame


class InverseParams(NamedTuple):
    vert_offsets: Any  # [nv, 3]
    diffuse: Any  # [k, 4]
    specular: Any  # [k, 4]


def init_params(scene: Scene) -> InverseParams:
    return InverseParams(
        vert_offsets=jnp.zeros_like(scene.verts),
        diffuse=jnp.asarray(scene.materials.diffuse),
        specular=jnp.asarray(scene.materials.specular),
    )


def apply_params(params: InverseParams, scene: Scene) -> Scene:
    return scene.replace(
        verts=scene.verts + params.vert_offsets,
        materials=scene.materials.replace(
            diffuse=params.diffuse, specular=params.specular
        ),
    )


def loss_fn(params, scene, camera, target, cfg: RenderConfig):
    img = render_frame(apply_params(params, scene), camera, cfg)
    return jnp.mean((img - target) ** 2)


def make_optimizer(lr: float = 1e-2):
    return optax.adam(lr)


@functools.partial(jax.jit, static_argnames=("cfg",))
def train_step(params, opt_state, scene, camera, target, cfg: RenderConfig,
               lr=1e-2):
    """Single-device training step (the sharded variant lives in
    parallel/render.py train_step_sharded).

    ``lr`` is a traced scalar (adam's update is lr-linear, so tracing it
    costs nothing and lets the CLI's --lr take effect; adam's *init* is
    lr-independent, so the optimizer state alone cannot carry it)."""
    loss, grads = jax.value_and_grad(loss_fn)(params, scene, camera, target, cfg)
    updates, opt_state = make_optimizer(lr).update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    return params, opt_state, loss
