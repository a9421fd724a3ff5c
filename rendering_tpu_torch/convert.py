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
Only the canonical arrays, each mesh's BVH reach boxes
("meshes.0.reach_lo", "meshes.0.reach_hi") and its BVH arrays
("meshes.0.node_min", "node_max", "skip", "real_flag", "leaf_start",
"leaf_count", "leaf_tris": what the showAC and closest-hit walks read)
are read, so both packages walk the same tree; the kernel chunk
tables (per mesh, or fused for two or more meshes) are rebuilt from
them exactly as `models.scene.build_scene` builds them, and the gather
tables are derived in each render. The BVH counts (n_real_nodes,
tri_copies) come with the static.

`params_from_numpy` carries a JAX parameter dict (`diff.inverse`
extract_params, as numpy) across in the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from rendering_tpu_torch.device import resolve_device
from rendering_tpu_torch.models.scene import (
    BVH_FIELDS,
    LightData,
    MeshStatic,
    SceneData,
    SceneStatic,
    fused_tables,
    mesh_data,
    uses_fused_tables,
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

    def t(key):
        a = np.asarray(leaves[key])
        dtype = torch.int32 if a.dtype.kind in "iu" else torch.float32
        return torch.tensor(a, dtype=dtype)

    meshes, reach = [], []
    for i, ms in enumerate(st.meshes):
        def arr(name, i=i):
            return leaves.get(f"meshes.{i}.{name}")

        reach.append((arr("reach_lo"), arr("reach_hi")))
        meshes.append(mesh_data(
            ms, arr("v"), arr("n"), arr("uv"), arr("tangent"),
            arr("bitangent"), arr("diffuse_map"), arr("normal_map"),
            arr("specular_map"), reach=reach[-1],
            fused=uses_fused_tables(st.settings, st.n_meshes),
            nodes=tuple(arr(k) for k in BVH_FIELDS),
        ))
    ft, fts = fused_tables(
        st, [leaves[f"meshes.{i}.v"] for i in range(st.n_meshes)], reach)
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
        fused_itables=ft,
        fused_shadow_itables=fts,
        static=st,
    )
    return scene.to(device)


def params_from_numpy(params: dict[str, np.ndarray], device=None) -> dict:
    """The port's parameter dict (`diff.inverse.extract_params` keys ->
    leaf tensors that require grad) from a JAX parameter dict read as
    numpy. Runs on the CUDA device unless `device` says otherwise."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                            device=device).requires_grad_(True)
            for k, v in params.items()}
