"""Scene definitions and map-texel decoders — the parts of
`rendering_tpu.models.parser` the port uses (`parse_scene` comes with
the CLI slice). Plain dataclasses and numpy: the input to
`models.scene.build_scene`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from rendering_tpu_torch.models.objloader import MeshArrays, _normalize_rows
from rendering_tpu_torch.models.settings import RenderSettings


@dataclasses.dataclass
class LightDef:
    kind: str  # "distant" | "point" | "area"
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    dir: tuple = (0.0, 0.0, -1.0)   # distant
    pos: tuple = (0.0, 0.0, 0.0)    # point / area
    i: tuple = (0.0, 0.0, 0.0)      # area basis vectors
    j: tuple = (0.0, 0.0, 0.0)
    samples: int = 1


@dataclasses.dataclass
class ObjectDef:
    kind: str  # "sphere" | "plane" | "mesh"
    pos: tuple = (1.0, 1.0, 1.0)
    color: tuple = (1.0, 1.0, 1.0)
    material: str = "diffuse"  # diffuse | phong | reflective | transparent
    ior: float = 1.4
    ambient: float = 0.1
    diffuse: float = 0.1
    specular: float = 1.0
    n_specular: float = 5.0
    # sphere
    radius: float = 1.0
    # plane
    normal: tuple = (0.0, 1.0, 0.0)
    # mesh
    size: tuple = (0.0, 0.0, 0.0)
    rot: tuple = (0.0, 0.0, 0.0)
    mesh: Optional[MeshArrays] = None
    diffuse_map: Optional[np.ndarray] = None   # (H*W, 3) f32, loadBMP layout
    diffuse_map_wh: tuple[int, int] = (0, 0)
    normal_map: Optional[np.ndarray] = None
    normal_map_wh: tuple[int, int] = (0, 0)
    specular_map: Optional[np.ndarray] = None  # (H*W, 1) f32
    specular_map_wh: tuple[int, int] = (0, 0)


@dataclasses.dataclass
class SceneDef:
    settings: RenderSettings
    cam_pos: tuple = (0.0, 0.0, 0.0)
    cam_rot: tuple = (0.0, 0.0, 0.0)
    lights: list = dataclasses.field(default_factory=list)
    objects: list = dataclasses.field(default_factory=list)
    skybox: Optional[np.ndarray] = None  # (6, H, W, 3) f32, loadBMP row order
    skybox_wh: tuple[int, int] = (0, 0)


def decode_normal_map(flat: np.ndarray) -> np.ndarray:
    """Reference normal-map texel transform (objects.cpp:417-437):
    Vec3f{x*2-1, -(y*2-1), z}.normalize() — z stays the raw [0,1]
    value, and normalize multiplies by 1/sqrt(len2) (geometry.h:104-112)."""
    nm = flat * 2.0 - 1.0
    nm[:, 1] = -nm[:, 1]
    nm[:, 2] = (nm[:, 2] + 1.0) / 2.0
    return _normalize_rows(nm).astype(np.float32)


def decode_specular_map(flat: np.ndarray) -> np.ndarray:
    """Reference specular decode: gray average (objects.cpp:454), kept
    as an (H*W, 1) column."""
    return np.mean(flat, axis=1, keepdims=True).astype(np.float32)
