"""Render settings — the fields of `rendering_tpu.models.settings` that
the port reads, and the scene-file key map.

TPU-only knobs (pallas_interpret, use_mxu_intersect, anyhit_tri_chunk,
anyhit_n_sub, bruteforce_threshold, tri_chunk) have no counterpart here.
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
