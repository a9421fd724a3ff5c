"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
carrying a JAX scene across as numpy, and the golden u8 measures."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from rendering_tpu_torch.convert import scene_from_numpy


def jax_leaves(scene) -> dict:
    """A JAX scene's array leaves as numpy, keyed by dotted path."""
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(x)
            for p, x in flat}


def jax_static(scene) -> dict:
    """A JAX scene's static as a plain dict, with each mesh's
    clipped_by_root (a static field of its MeshData) added."""
    d = dataclasses.asdict(scene.static)
    d["meshes"] = [dict(m, clipped_by_root=md.clipped_by_root)
                   for m, md in zip(d["meshes"], scene.meshes)]
    return d


def port_scene(jax_scene, device="cpu"):
    """The port's SceneData carrying the JAX scene's arrays."""
    return scene_from_numpy(jax_leaves(jax_scene), jax_static(jax_scene),
                            device=device)


def golden_fractions(a_u8, b_u8):
    """(frac of interior u8 values differing by > 1, by > 8) — the first
    two measures of tests/test_golden.py, 1-pixel border excluded."""
    d = np.abs(a_u8.astype(np.int16) - b_u8.astype(np.int16))[1:-1, 1:-1]
    return float((d > 1).mean()), float((d > 8).mean())
