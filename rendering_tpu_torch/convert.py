"""Scene leaves carried across from the JAX package.

`scene_from_numpy` turns a JAX scene's array leaves, read as numpy by
the caller, into the port's SceneData, so both packages render
bit-identical inputs. The port itself never sees JAX: the caller
flattens the JAX scene, e.g.

    leaves = {jax.tree_util.keystr(path, simple=True, separator="."):
              np.asarray(x)
              for path, x in jax.tree_util.tree_flatten_with_path(scene)[0]}
    static = dataclasses.asdict(scene.static)

Keys are dotted paths ("cam_pos", "meshes.0.v", "lights.1.color").
Only the canonical arrays are read; the mesh gather table, the packed
map table and the kernel chunk tables are rebuilt from them exactly as
`models.scene.build_scene` builds them.
"""

from __future__ import annotations

import numpy as np
import torch

from rendering_tpu_torch.device import resolve_device
from rendering_tpu_torch.models.scene import (
    LightData,
    MeshStatic,
    SceneData,
    SceneStatic,
    check_supported,
    mesh_data,
)
from rendering_tpu_torch.models.settings import RenderSettings

_SCENE_KEYS = (
    "cam_pos", "cam_rmat", "scale", "bg_color", "bias", "obj_color",
    "obj_ior", "obj_ambient", "obj_diffuse", "obj_specular", "obj_nspec",
    "mat_type", "sph_pos", "sph_r", "pln_pos", "pln_n",
)
_LIGHT_KEYS = ("color", "intensity", "dir", "pos", "ivec", "jvec")


def _static_from_dict(d: dict) -> SceneStatic:
    """SceneStatic from the JAX scene's static as a plain dict. Each mesh
    dict may carry "clipped_by_root" (a static field of the JAX MeshData,
    so not a leaf); it defaults to False."""
    names = set(MeshStatic.__dataclass_fields__)
    meshes = tuple(
        MeshStatic(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in m.items() if k in names})
        for m in d["meshes"]
    )
    return SceneStatic(
        settings=RenderSettings.from_dict(d["settings"]),
        obj_kinds=tuple(d["obj_kinds"]),
        obj_subs=tuple(d["obj_subs"]),
        mat_types=tuple(d["mat_types"]),
        light_kinds=tuple(d["light_kinds"]),
        light_samples=tuple(d["light_samples"]),
        meshes=meshes,
        skybox_wh=tuple(d.get("skybox_wh", (0, 0))),
    )


def scene_from_numpy(leaves: dict[str, np.ndarray], static: dict,
                     device=None) -> SceneData:
    """The port's SceneData from a JAX scene's leaves (dotted-path keys ->
    numpy arrays) and its static (a plain dict). Runs on the CUDA device
    unless `device` says otherwise."""
    device = resolve_device(device)
    st = _static_from_dict(static)
    check_supported(st)

    def t(key):
        a = np.asarray(leaves[key])
        dtype = torch.int32 if a.dtype.kind in "iu" else torch.float32
        return torch.tensor(a, dtype=dtype)

    meshes = []
    for i, ms in enumerate(st.meshes):
        def arr(name, i=i):
            return leaves.get(f"meshes.{i}.{name}")

        meshes.append(mesh_data(
            ms, arr("v"), arr("n"), arr("uv"), arr("tangent"),
            arr("bitangent"), arr("diffuse_map"), arr("normal_map"),
            arr("specular_map"),
        ))
    lights = tuple(
        LightData(**{k: t(f"lights.{i}.{k}") for k in _LIGHT_KEYS},
                  kind=kind, samples=samples)
        for i, (kind, samples) in enumerate(zip(st.light_kinds,
                                                st.light_samples))
    )
    scene = SceneData(
        **{k: t(k) for k in _SCENE_KEYS},
        meshes=tuple(meshes),
        lights=lights,
        skybox=t("skybox") if "skybox" in leaves else None,
        static=st,
    )
    return scene.to(device)
