"""Scene-file parser — the port's copy of `rendering_tpu.models.parser`,
the reference's INI-ish `.scene` grammar (`Scene::loadScene`,
src/scene.cpp:62-334):

* `[options]` / `[light]` / `[object]` / `[end]` blocks; any other
  bracketed line is an error (scene.cpp:126-127).
* Any line containing '[' finishes the current light/object block
  (scene.cpp:96-107), `#[` block-comment openers included.
* `#[` starts a block comment skipped until a line containing '[' that
  is not itself `#[` (scene.cpp:110-116); that line is then processed
  (comment strip + block select) without finishing the previous block
  again, as in the reference.
* Everything from the first '#' on a line is dropped (scene.cpp:119-120).
* `[options]` keys have spaces/tabs stripped from the key only
  (scene.cpp:138-140); light/object keys are matched verbatim.
* Values parse with C++ stringstream semantics (util.h:41-67): see the
  `_to_*` casts.

Asset paths (OBJ files, maps, skyboxes) resolve against the current
directory, as the reference's do. The output is a host-side SceneDef of
plain dataclasses and numpy arrays, the input to
`models.scene.build_scene`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from rendering_tpu_torch.models.objloader import (
    MeshArrays,
    _normalize_rows,
    load_obj,
)
from rendering_tpu_torch.models.settings import OPTION_KEY_MAP, RenderSettings
from rendering_tpu_torch.utils.bmp import load_bmp_float
from rendering_tpu_torch.utils.timer import Timer


class SceneError(RuntimeError):
    """Raised where the reference would LOG_ERROR() and exit(-1)."""


# Value conversion replicates C++ `stringstream >> x` plus the
# `if (!ss.eof() && !ss.good()) LOG_ERROR()` check (util.h:41-67), which
# is not Python's int()/float():
#   * leading whitespace skipped; num_get consumes the longest chain the
#     float grammar can extend, trailing junk is ignored
#     ("1_0" -> 1, "1.5abc" -> 1.5, "1.2.3" -> 1.2);
#   * empty/whitespace-only -> 0 without error;
#   * stopping in an incomplete grammar state ("+", ".", "1e", "1e+",
#     "1.e") errors if input remains ("+a", ".x", "1ex", "1e+x"), but
#     yields 0 at end-of-string ("-", "1e", "1e-" -> +0.0);
#   * "inf"/"nan" are not in num_get's grammar -> error;
#   * hex forms are consumed but never convert: "0x1p3"/"0x10" -> 0.0
#     ("-0x2" -> -0.0), junk after the hex body is ignored ("0xg").


def _to_float(s: str) -> float:
    t = s.lstrip()
    if not t:
        return 0.0
    i, n = 0, len(t)
    sign = 1.0
    if t[i] in "+-":
        sign = -1.0 if t[i] == "-" else 1.0
        i += 1
    # hex accumulation: consumed but conversion always fails -> +-0.0
    if t[i : i + 2] in ("0x", "0X"):
        i += 2
        while i < n and (t[i] in "0123456789abcdefABCDEF."):
            i += 1
        if i < n and t[i] in "pP":
            i += 1
            if i < n and t[i] in "+-":
                i += 1
            j = i
            while i < n and t[i].isdigit():
                i += 1
            if i == j and i < n:  # incomplete p-exponent, junk next
                raise SceneError(f"bad float: {s!r}")
        return sign * 0.0
    had_digits = False
    while i < n and t[i].isdigit():
        had_digits = True
        i += 1
    if i < n and t[i] == ".":
        i += 1
        while i < n and t[i].isdigit():
            had_digits = True
            i += 1
    if not had_digits:
        # only sign and/or '.' consumed: incomplete state
        if i < n:
            raise SceneError(f"bad float: {s!r}")
        # a failed conversion stores +0.0: the sign does not survive,
        # unlike the hex path above
        return 0.0
    mant_end = i
    if i < n and t[i] in "eE":
        i += 1
        if i < n and t[i] in "+-":
            i += 1
        j = i
        while i < n and t[i].isdigit():
            i += 1
        if i == j:
            if i < n:  # "1ex"/"1e+x": incomplete exponent, junk next
                raise SceneError(f"bad float: {s!r}")
            # "1e"/"1e+"/"-1e" at end: the conversion fails -> +0.0
            return 0.0
        return float(t[:i])
    return float(t[:mant_end])


def _to_int(s: str) -> int:
    t = s.lstrip()
    if not t:
        return 0
    i, n = 0, len(t)
    if t[i] in "+-":
        i += 1
    j = i
    while i < n and t[i].isdigit():
        i += 1
    if i == j:
        # sign-only or no digits: incomplete; junk remaining errors
        if i < n:
            raise SceneError(f"bad int: {s!r}")
        return 0
    return int(t[:i])


def _to_bool(s: str) -> bool:
    # Stream bool extraction parses an integer; any nonzero stores true
    # (an out-of-range value sets failbit only at eof, so the
    # reference's check still passes).
    return bool(_to_int(s))


def _to_vec3(s: str) -> tuple[float, float, float]:
    parts = s.split(",")
    # std::getline(stream, cell, ',') yields no final empty cell for a
    # single trailing delimiter ("1,2,3," -> 3 cells in the reference's
    # splitString, util.h:78-86): drop exactly that one.
    if s.endswith(",") and parts and parts[-1] == "":
        parts.pop()
    if len(parts) != 3:
        raise SceneError(f"bad vec3: {s!r}")
    return (_to_float(parts[0]), _to_float(parts[1]), _to_float(parts[2]))


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


def _require_map_file(path: str) -> None:
    """The reference's loadBMP prints and LOG_ERROR-exits when a texture
    map cannot be opened (util.cpp:78-85)."""
    if not os.path.exists(path):
        raise SceneError(f"Could not open .bmp file: {path}")


def _load_map(path: str):
    """BMP -> float array in the reference's flat layout (u8/256)."""
    data = load_bmp_float(path)  # (H, W, 3) rows bottom-up as loadBMP
    h, w = data.shape[:2]
    return data.reshape(h * w, 3), (w, h)


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


def parse_scene(path: str, base_settings: RenderSettings | None = None) -> SceneDef:
    """Parse a `.scene` file, loading its OBJ files, maps and skybox.
    Scene-file options override `base_settings`."""
    settings_kw: dict = {}
    sd = SceneDef(settings=base_settings or RenderSettings())
    light: LightDef | None = None
    obj: ObjectDef | None = None
    block = None  # None | "options" | "light" | "object"
    block_map = {"[options]": "options", "[light]": "light", "[object]": "object",
                 "[end]": None}

    if not os.path.exists(path):
        raise SceneError(f"Could not open scene file: {path}")

    def finish_block():
        nonlocal light, obj
        if block == "light":
            if light is None:
                raise SceneError("empty [light] block")
            sd.lights.append(light)
            light = None
        elif block == "object":
            if obj is None:
                raise SceneError("empty [object] block")
            sd.objects.append(obj)
            obj = None

    with open(path, "r", errors="replace") as fh:
        lines = [ln.rstrip("\r\n") for ln in fh]

    idx = 0
    n_lines = len(lines)
    while idx < n_lines:
        line = lines[idx]
        idx += 1
        if len(line) == 0:
            continue

        if "[" in line:
            finish_block()

        if "#[" in line:
            # Skip the commented block (scene.cpp:110-116).
            while idx < n_lines:
                line = lines[idx]
                idx += 1
                if "[" in line and "#[" not in line:
                    break
            else:
                break  # EOF inside the block comment

        if "#" in line:
            line = line[: line.index("#")]
        if len(line) == 0:
            continue

        if line[0] == "[":
            if line not in block_map:
                raise SceneError(f"unknown block: {line!r}")
            block = block_map[line]
            if block is None:
                break
            continue

        if block == "options":
            if "=" not in line:
                raise SceneError(f"bad options line: {line!r}")
            key = line[: line.index("=")].replace(" ", "").replace("\t", "")
            value = line[line.index("=") + 1 :]
            if key in OPTION_KEY_MAP:
                field, typ = OPTION_KEY_MAP[key]
                cast = {"bool": _to_bool, "int": _to_int, "float": _to_float,
                        "str": str}[typ]
                settings_kw[field] = cast(value)
            elif key == "background_color":
                settings_kw["background_color"] = _to_vec3(value)
            elif key == "position":
                sd.cam_pos = _to_vec3(value)
            elif key == "rotation":
                sd.cam_rot = _to_vec3(value)
            elif key == "skyboxes":
                names = value.split(",")
                # getline with a delimiter yields no cell for a trailing
                # delimiter (util.h:77-85), so "a,b,c,d,e," is five cells
                # in the reference (LOG_ERROR), not five + "".
                if names and names[-1] == "":
                    names.pop()
                if len(names) < 6:
                    raise SceneError("skyboxes needs 6 names")
                settings_kw["skybox_names"] = tuple(names[:6])
                settings_kw["use_skybox"] = True  # scene.cpp:193
            else:
                print(f"Scene, unknown key: {key}")

        elif block == "light":
            if "=" not in line:
                raise SceneError(f"bad light line: {line!r}")
            key = line[: line.index("=")]
            value = line[line.index("=") + 1 :]
            if key == "type":
                if value == "distant":
                    light = LightDef("distant")
                elif value == "point":
                    light = LightDef("point")
                elif value == "area":
                    light = LightDef("area")
            elif light is None:
                print("Error, light type missing")
            elif key == "color":
                light.color = _to_vec3(value)
            elif key == "intensity":
                light.intensity = _to_float(value)
            # A second chain on purpose: the reference's dispatch is split
            # in two (scene.cpp:219 starts a fresh `if` after the
            # type/color/intensity chain), so `direction=` before any
            # `type=` prints the type-missing warning and then fails (the
            # reference dereferences nullptr there; this raises).
            if key == "direction":
                if light is None or light.kind != "distant":
                    raise SceneError("direction on non-distant light")
                light.dir = _to_vec3(value)
            elif key == "position":
                if light is None or light.kind != "point":
                    raise SceneError("position on non-point light")
                light.pos = _to_vec3(value)
            elif key == "pos":
                if light is None or light.kind != "area":
                    raise SceneError("pos on non-area light")
                light.pos = _to_vec3(value)
            elif key == "i":
                if light is None or light.kind != "area":
                    raise SceneError("i on non-area light")
                light.i = _to_vec3(value)
            elif key == "j":
                if light is None or light.kind != "area":
                    raise SceneError("j on non-area light")
                light.j = _to_vec3(value)
            elif key == "samples":
                if light is None or light.kind != "area":
                    raise SceneError("samples on non-area light")
                light.samples = _to_int(value)

        elif block == "object":
            if "=" not in line:
                raise SceneError(f"bad object line: {line!r}")
            key = line[: line.index("=")]
            value = line[line.index("=") + 1 :]
            if key == "type":
                if value == "plane":
                    obj = ObjectDef("plane")
                elif value == "sphere":
                    # Sphere's ctor defaults the center to 0 (objects.h:170),
                    # unlike the Object base default of 1 that plane and
                    # mesh inherit (objects.h:27, :184).
                    obj = ObjectDef("sphere", pos=(0.0, 0.0, 0.0))
                elif value == "mesh":
                    obj = ObjectDef("mesh")
            elif obj is None:
                print("Error, object type missing")
            elif key == "color":
                obj.color = _to_vec3(value)
            elif key == "pos":
                obj.pos = _to_vec3(value)
            elif key == "material":
                res = value.split(",")
                # Missing fields index past the reference's vector
                # (scene.cpp:273-288 reads res[1..4] unchecked, UB): fail
                # with context instead.
                need = {"transparent": 2, "phong": 5}.get(res[0], 1)
                if len(res) < need:
                    raise SceneError(
                        f"material {res[0]!r} needs {need - 1} value(s): "
                        f"{line!r}"
                    )
                if res[0] == "transparent":
                    obj.material = "transparent"
                    obj.ior = _to_float(res[1])
                elif res[0] == "reflective":
                    obj.material = "reflective"
                if res[0] == "phong":
                    obj.material = "phong"
                    obj.ambient = _to_float(res[1])
                    obj.diffuse = _to_float(res[2])
                    obj.specular = _to_float(res[3])
                    obj.n_specular = _to_float(res[4])
            elif obj.kind == "sphere":
                if key == "radius":
                    obj.radius = _to_float(value)
            elif obj.kind == "plane":
                if key == "normal":
                    obj.normal = _to_vec3(value)
            elif obj.kind == "mesh":
                # The settings as parsed so far, for the bias at OBJ load
                # and the textures switch at map load.
                cur = (base_settings or RenderSettings()).replace(**settings_kw)
                if key == "size":
                    obj.size = _to_vec3(value)
                elif key == "rot":
                    obj.rot = _to_vec3(value)
                elif key == "name":
                    # The reference times each OBJ load (objects.cpp:217),
                    # printed under enableOutput.
                    t_obj = Timer("OBJ loading", cur.enable_output,
                                  span="rt.scene.obj")
                    obj.mesh = load_obj(
                        value, obj.size, obj.rot, obj.pos, bias=cur.bias
                    )
                    t_obj.stop()
                elif key == "diffuse_map":
                    if cur.use_textures:
                        _require_map_file(value)
                        obj.diffuse_map, obj.diffuse_map_wh = _load_map(value)
                elif key == "normal_map":
                    if cur.use_textures:
                        _require_map_file(value)
                        nm, wh = _load_map(value)
                        obj.normal_map = decode_normal_map(nm)
                        obj.normal_map_wh = wh
                elif key == "specular_map":
                    if cur.use_textures:
                        _require_map_file(value)
                        sm, wh = _load_map(value)
                        obj.specular_map = decode_specular_map(sm)
                        obj.specular_map_wh = wh

    sd.settings = (base_settings or RenderSettings()).replace(**settings_kw)

    # Skybox (scene.cpp:336-360): 6 BMPs -> float arrays; width/height
    # from the last one loaded.
    if sd.settings.use_skybox and sd.settings.skybox_names:
        faces = []
        wh = (0, 0)
        for name in sd.settings.skybox_names:
            _require_map_file(name)
            face = load_bmp_float(name)  # (H, W, 3), loadBMP row order
            wh = (face.shape[1], face.shape[0])
            faces.append(face)
        sd.skybox = np.stack(faces).astype(np.float32)
        sd.skybox_wh = wh

    return sd
