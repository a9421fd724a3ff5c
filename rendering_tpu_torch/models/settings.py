"""Render settings — the fields of `rendering_tpu.models.settings` that
the port reads.

TPU-only knobs (pallas_interpret, use_mxu_intersect, geo_shard_axis,
anyhit_*, bruteforce_threshold) have no counterpart here.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    width: int = 800
    height: int = 600
    bias: float = 0.0001
    background_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    use_backface_culling: bool = True
    collect_statistics: bool = False
    use_ac: bool = True
    show_ac: bool = False
    use_skybox: bool = False
    show_normals: bool = False
    enable_ssaa: bool = True
    fov: float = 60.0
    # Paths with throughput at or below this weight are inactive.
    min_weight: float = 0.0
    # "nearest" (the reference's truncating texel index) or "bilinear".
    texture_filter: str = "nearest"

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "RenderSettings":
        """Settings from a plain dict (e.g. the JAX package's settings as
        `dataclasses.asdict`), keeping only the fields the port has."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if "background_color" in kw:
            kw["background_color"] = tuple(kw["background_color"])
        return cls(**kw)
