"""Render settings — the fields of `rendering_tpu.models.settings` that
the port reads, and the scene-file key map.

The intersection oracle's choice carries over with the JAX package's
names and defaults (use_pallas_intersect, bruteforce_threshold,
use_mxu_intersect, tri_chunk; `render.integrator` dispatches on them).
The TPU's own knobs (pallas_interpret, a test hook of the Pallas
interpreter, and anyhit_tri_chunk, anyhit_n_sub, chunk shapes of the
Pallas tables) have no counterpart here.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    # Options class fields (include/options.h:12-19)
    width: int = 800
    height: int = 600
    bias: float = 0.0001
    max_ray_depth: int = 10
    n_workers: int = 32          # parity field; the port does not read it
    background_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    ac_penalty: int = 1
    skybox_names: tuple[str, ...] = ()
    image_name: str = "out"

    # namespace options globals (include/options.h:23-37)
    output_progress: bool = True
    use_backface_culling: bool = True
    collect_statistics: bool = False
    enable_output: bool = True
    image_output: bool = True
    use_ac: bool = True
    show_ac: bool = False
    use_skybox: bool = False
    use_textures: bool = True
    show_normals: bool = False
    enable_ssaa: bool = True

    # Camera (include/scene.h:58)
    fov: float = 60.0

    # BVH leaves are chunked to this many triangles when flattened.
    leaf_chunk: int = 8
    # Paths with throughput at or below this weight are inactive.
    min_weight: float = 0.0
    # Static capacity of the SSAA refinement queue as a fraction of the
    # pixel count; a larger Sobel mask re-renders at a raised capacity
    # (render.pipeline.escalating_render).
    ssaa_capacity_fraction: float = 0.25
    # Two-phase shadow query of a single mesh (the any-hit K6,
    # ops/cuda_intersect.any_hit_two_phase): the first round(frac * Cs)
    # super chunks, then the unresolved rays packed densely against the
    # rest. 0.0 = the single-pass any hit (K2).
    anyhit_compact_frac: float = 0.0
    # The intersection oracle of each mesh query (JAX's _mesh_oracle).
    # True: the hand-written tile-walk kernels K1-K6
    # (ops/cuda_intersect.py), the counterparts of JAX's Pallas kernel.
    # False: a mesh of at most bruteforce_threshold triangles takes the
    # dense chunked Moller-Trumbore, as a bilinear-form matmul
    # (ops/bruteforce_mxu.py) when use_mxu_intersect, else direct
    # (ops/bruteforce.py), tri_chunk triangles a step; a larger one the
    # threaded-BVH walk (ops/traversal.py::traverse_bvh). Every mesh is
    # then queried on its own, in a scene of several meshes too.
    use_pallas_intersect: bool = True
    bruteforce_threshold: int = 8192
    use_mxu_intersect: bool = True
    tri_chunk: int = 256
    # "nearest" (the reference's truncating texel index) or "bilinear".
    texture_filter: str = "nearest"
    # By-primitive geometry sharding (`parallel.geoshard`): set to "geo"
    # at build time, the scene takes the fused tables even for one mesh
    # and keeps its per-triangle tensors in host memory until each rank
    # stages its own shard; trace_closest and trace_occlusion then
    # combine each ray's result over the scene's geo group. Such a scene
    # renders only through `parallel.geoshard`.
    geo_shard_axis: str | None = None

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "RenderSettings":
        """Settings from a plain dict (e.g. the JAX package's settings as
        `dataclasses.asdict`), keeping only the fields the port has."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        for k in ("background_color", "skybox_names"):
            if k in kw:
                kw[k] = tuple(kw[k])
        return cls(**kw)


# scene-file key -> settings field for the [options] block (bool globals
# and scalar options). Handled by the parser itself: skyboxes,
# background_color, position, rotation (camera).
OPTION_KEY_MAP = {
    "outputProgress": ("output_progress", "bool"),
    "useBackfaceCulling": ("use_backface_culling", "bool"),
    "collectStatistics": ("collect_statistics", "bool"),
    "enableOutput": ("enable_output", "bool"),
    "imageOutput": ("image_output", "bool"),
    "useAC": ("use_ac", "bool"),
    "showAC": ("show_ac", "bool"),
    "useSkybox": ("use_skybox", "bool"),
    "useTextures": ("use_textures", "bool"),
    "showNormals": ("show_normals", "bool"),
    "width": ("width", "int"),
    "height": ("height", "int"),
    "fov": ("fov", "float"),
    "n_workers": ("n_workers", "int"),
    "max_ray_depth": ("max_ray_depth", "int"),
    "ac_penalty": ("ac_penalty", "int"),
    "image_name": ("image_name", "str"),
}
