"""The reference renderer: a plain PyTorch Whitted raytracer with the
upstream engine's shading (holoskii/Rendering, src/scene.cpp:672-946),
written for the benchmark's comparisons and independent of the program.

A frame: one primary ray per pixel through (x + 1, y + 1) (the engine
adds 0.5 twice), the last row and column left black; each ray's path
tree followed as a wavefront for max_ray_depth + 1 bounces in a scene
with reflective or transparent objects (one bounce otherwise), the paths
still alive after them taking the background; then adaptive SSAA: the
pixels whose Sobel value of the frame exceeds 0.5 replaced by the mean
of four rays at (x + 0.75 +- 0.25, y + 0.75 +- 0.25). A hit shades
diffuse, phong (ambient, diffuse and specular, texture maps on meshes),
reflective (specular highlight plus a child at weight 0.8) or
transparent (specular highlight times the Fresnel reflectance, plus the
reflected and refracted children at kr and 1 - kr). Point lights fall
off as min(1, I / (4 pi d^2 / 1000)); shadow rays leave the hit biased
along the normal and transparent objects cast no shadow.

A mesh hit is found on the geometry the scene was built with and then
evaluated again, differentiably, on the current vertices (a ray whose
triangle no longer holds it misses), as inverse rendering does. Every
float is in `dtype`: float32 for the reference, a lower precision for
its control.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .accel import TriangleAccel, dot, moller_trumbore
from .files import euler_matrix, load_map, load_obj, reach_boxes

FLT_MAX = 3.4028234663852886e38
# The largest bfloat16, the miss value of the lower-precision control.
BF16_MAX = 3.3895313892515355e38
# Primary rays per wavefront block (bounds every per-ray temporary).
BLOCK = 1 << 18


def _big(dtype) -> float:
    return BF16_MAX if dtype == torch.bfloat16 else FLT_MAX


def normalize(a):
    len2 = dot(a, a)[..., None]
    pos = len2 > 0
    return torch.where(pos, a * (1.0 / torch.sqrt(torch.where(pos, len2, 1.0))),
                       a)


@dataclasses.dataclass
class Mesh:
    v: torch.Tensor          # (T, 3, 3) current vertices
    n: torch.Tensor          # (T, 3, 3)
    uv: torch.Tensor         # (T, 3, 2)
    tangent: torch.Tensor    # (T, 3)
    bitangent: torch.Tensor  # (T, 3)
    maps: dict               # kind -> ((W*H, C) table, (W, H))
    accel: TriangleAccel     # on the geometry the scene was built with


@dataclasses.dataclass
class Scene:
    width: int
    height: int
    bias: float
    max_depth: int
    ssaa: bool
    culling: bool
    bg: torch.Tensor         # (3,)
    scale: float
    aspect: float
    cam_pos: torch.Tensor    # (3,)
    cam_rmat: torch.Tensor   # (3, 3)
    kinds: list              # per object: "sphere" | "plane" | "mesh"
    mats: list               # per object: material name
    color: torch.Tensor      # (No, 3)
    ior: list
    ambient: list
    diffuse: list
    specular: list
    nspec: list
    geom: list               # sphere (pos, r) | plane (pos, n) | Mesh
    lights: list             # {"type", "color", "intensity", "dir"/"pos"}

    @property
    def bouncing(self) -> bool:
        return any(m in ("reflective", "transparent") for m in self.mats)

    def meshes(self) -> list:
        return [g for g, k in zip(self.geom, self.kinds) if k == "mesh"]

    def with_params(self, params: dict) -> "Scene":
        """The scene with tensors replaced: "lights/<i>/intensity",
        "obj_color", "meshes/<i>/v"."""
        lights = [dict(li) for li in self.lights]
        geom = list(self.geom)
        color = self.color
        mesh_slots = [i for i, k in enumerate(self.kinds) if k == "mesh"]
        for key, val in params.items():
            parts = key.split("/")
            if parts[0] == "lights":
                lights[int(parts[1])][parts[2]] = val
            elif parts[0] == "obj_color":
                color = val
            elif parts[0] == "meshes":
                slot = mesh_slots[int(parts[1])]
                geom[slot] = dataclasses.replace(geom[slot], v=val)
        return dataclasses.replace(self, lights=lights, geom=geom, color=color)

    def get(self, key: str) -> torch.Tensor:
        parts = key.split("/")
        if parts[0] == "lights":
            return self.lights[int(parts[1])][parts[2]]
        if parts[0] == "obj_color":
            return self.color
        return self.meshes()[int(parts[1])].v


def build(desc: dict, *, device, dtype=torch.float32) -> Scene:
    """A scene from a description (see `files.parse_scene`): a mesh object
    carries either "arrays" (v, n, uv, tangent, bitangent, root_bounds)
    or an "obj" path, and its "maps" as {kind: BMP path}."""
    st = desc["settings"]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)

    kinds, mats, geom = [], [], []
    color, ior, amb, dif, spec, nspec = [], [], [], [], [], []
    for o in desc["objects"]:
        kinds.append(o["type"])
        mats.append(o.get("material", "diffuse"))
        color.append(o.get("color", (1.0, 1.0, 1.0)))
        ior.append(float(o.get("ior", 1.4)))
        amb.append(float(o.get("ambient", 0.1)))
        dif.append(float(o.get("diffuse", 0.1)))
        spec.append(float(o.get("specular", 1.0)))
        nspec.append(float(o.get("n_specular", 5.0)))
        if o["type"] == "sphere":
            geom.append((t(o["pos"]), float(o["radius"])))
        elif o["type"] == "plane":
            geom.append((t(o["pos"]), t(o["normal"])))
        else:
            arrays = o.get("arrays") or load_obj(
                o["obj"], o["size"], o["rot"], o["pos"], st.get("bias", 1e-4))
            v = arrays["v"]
            root = arrays["root_bounds"]
            clipped = bool((v.min(axis=(0, 1)) < root[0]).any()
                           or (v.max(axis=(0, 1)) > root[1]).any())
            reach = None
            if clipped and st.get("use_ac", True):
                reach = tuple(t(r) for r in reach_boxes(
                    v, root, int(st.get("ac_penalty", 1))))
            maps = {}
            for kind, path in o.get("maps", {}).items():
                table, wh = load_map(path, kind)
                maps[kind] = (t(table), wh)
            vt = t(v)
            geom.append(Mesh(
                v=vt, n=t(arrays["n"]), uv=t(arrays["uv"]),
                tangent=t(arrays["tangent"]),
                bitangent=t(arrays["bitangent"]), maps=maps,
                accel=TriangleAccel(vt, reach,
                                    st.get("use_backface_culling", True))))
    lights = []
    for li in desc["lights"]:
        rec = {"type": li["type"], "color": t(li.get("color", (1, 1, 1))),
               "intensity": t(li.get("intensity", 1.0))}
        if li["type"] == "distant":
            rec["dir"] = t(li["direction"])
        elif li["type"] == "point":
            rec["pos"] = t(li["position"])
        else:
            raise ValueError(f"light type {li['type']!r} is not in the "
                             "reference")
        lights.append(rec)
    w, h = int(st["width"]), int(st["height"])
    f32 = np.float32
    scale = np.tan(f32(st.get("fov", 60.0)) * f32(0.5) / f32(180.0)
                   * f32(np.pi))
    return Scene(
        width=w, height=h, bias=float(f32(st.get("bias", 1e-4))),
        max_depth=int(st.get("max_ray_depth", 10)),
        ssaa=bool(st.get("enable_ssaa", True)),
        culling=bool(st.get("use_backface_culling", True)),
        bg=t(st.get("background_color", (0, 0, 0))), scale=float(scale),
        aspect=float(f32(w) / f32(h)),
        cam_pos=t(desc["camera"]["position"]),
        cam_rmat=t(euler_matrix(desc["camera"]["rotation"])),
        kinds=kinds, mats=mats, color=t(color), ior=ior, ambient=amb,
        diffuse=dif, specular=spec, nspec=nspec, geom=geom, lights=lights)


# ---- rays and primitives ---------------------------------------------------

def camera_rays(scene: Scene, xs, ys, off_x: float, off_y: float):
    """Rays through pixel coordinates xs, ys (float) plus the offsets."""
    dt = scene.bg.dtype
    xs, ys = xs.to(dt), ys.to(dt)
    x = (2.0 * (xs + off_x) / scene.width - 1.0) * scene.scale * scene.aspect
    y = -(2.0 * (ys + off_y) / scene.height - 1.0) * scene.scale
    d = normalize(torch.stack([x, y, -torch.ones_like(x)], -1))
    r = scene.cam_rmat
    rd = d[:, 0:1] * r[0] + d[:, 1:2] * r[1] + d[:, 2:3] * r[2]
    return scene.cam_pos.expand(rd.shape), rd


def sphere_t(ro, rd, pos, radius: float):
    L = pos - ro
    tca = dot(L, rd)
    d2 = dot(L, L) - tca * tca
    r2 = radius * radius
    inside = d2 <= r2
    op = torch.clamp_min(r2 - d2, 0.0)
    dead = (~inside) | (op <= 0)
    thc = torch.where(dead, 0.0, torch.sqrt(torch.where(dead, 1.0, op)))
    t0 = tca - thc
    t0 = torch.where(t0 < 0, tca + thc, t0)
    return torch.where(inside & (t0 >= 0), t0, _big(t0.dtype))


def plane_t(ro, rd, pos, normal):
    denom = dot(rd, normal)
    ok = torch.abs(denom) >= 1e-8
    t = dot(pos - ro, normal) / torch.where(ok, denom, 1.0)
    return torch.where(ok & (t >= 0), t, _big(t.dtype))


def mesh_hit(mesh: Mesh, ro, rd, culling: bool):
    """(t, tri, u, v): the closest triangle on the built geometry, then
    t, u, v evaluated again on the current vertices."""
    t_lim = torch.full((ro.shape[0],), FLT_MAX, device=ro.device)
    tri = mesh.accel.closest(ro.detach(), rd.detach(), t_lim)
    found = tri >= 0
    g = mesh.v[torch.clamp_min(tri, 0)]
    t, u, v, ok = moller_trumbore(ro, rd, g[:, 0], g[:, 1] - g[:, 0],
                                  g[:, 2] - g[:, 0], culling)
    return torch.where(found & ok, t, _big(t.dtype)), tri, u, v


def sample(table, wh, tex):
    """Nearest texel: row int(H * ty), column int(W * tx), each clamped
    to the map on the high side (objects.cpp:146-148)."""
    w, h = wh
    wi = torch.clamp_max(torch.trunc(w * tex[:, 0]).to(torch.int64), w - 1)
    hi = torch.clamp_max(torch.trunc(h * tex[:, 1]).to(torch.int64), h - 1)
    idx = hi * w + wi
    idx = torch.clamp(torch.where(idx < 0, idx + w * h, idx), 0, w * h - 1)
    return table[idx]


# ---- one bounce -------------------------------------------------------------

def reflect(d, n):
    return d - 2.0 * dot(d, n)[:, None] * n


def refract(d, n, ior):
    cosi = torch.clamp(dot(d, n), -1.0, 1.0)
    outside = cosi < 0
    n1 = torch.where(outside, 1.0, ior)
    n2 = torch.where(outside, ior, 1.0)
    ca = torch.abs(cosi)
    nn = torch.where(outside[:, None], n, -n)
    eta = n1 / n2
    k = 1.0 - eta * eta * (1.0 - ca * ca)
    crit = k <= 0
    sk = torch.where(crit, 0.0, torch.sqrt(torch.where(crit, 1.0, k)))
    out = eta[:, None] * d + (eta * ca - sk)[:, None] * nn
    return torch.where((k < 0)[:, None], 0.0, out)


def fresnel(d, n, ior):
    cosi = torch.clamp(dot(d, n), -1.0, 1.0)
    inside = cosi > 0
    n1 = torch.where(inside, ior, 1.0)
    n2 = torch.where(inside, 1.0, ior)
    sin2 = torch.clamp_min(1.0 - cosi * cosi, 0.0)
    z = sin2 <= 0
    sint = n1 / n2 * torch.where(z, 0.0, torch.sqrt(torch.where(z, 1.0, sin2)))
    tir = sint >= 1.0
    cost = torch.sqrt(torch.where(tir, 1.0, torch.clamp_min(1.0 - sint * sint,
                                                            0.0)))
    ca = torch.abs(cosi)
    rs = (n2 * ca - n1 * cost) / (n2 * ca + n1 * cost)
    rp = (n1 * ca - n2 * cost) / (n1 * ca + n2 * cost)
    return torch.where(tir, 1.0, (rs * rs + rp * rp) / 2.0)


def spec_pow(base, e):
    pos = base > 0
    return torch.where(pos, torch.exp(e * torch.log(torch.where(pos, base, 1.0))),
                       0.0)


def occluded(scene: Scene, ro, rd, dist):
    """Any opaque object hit with t < dist."""
    occ = torch.zeros((ro.shape[0],), dtype=torch.bool, device=ro.device)
    for kind, mat, g in zip(scene.kinds, scene.mats, scene.geom):
        if mat == "transparent" or ro.shape[0] == 0:
            continue
        if kind == "sphere":
            occ = occ | (sphere_t(ro, rd, g[0], g[1]) < dist)
        elif kind == "plane":
            occ = occ | (plane_t(ro, rd, g[0], g[1]) < dist)
        else:
            open_ = torch.nonzero(~occ).reshape(-1)
            hit = g.accel.any_hit(ro[open_], rd[open_], dist[open_])
            occ = occ.index_put((open_,), hit | occ[open_])
    return occ


def bounce(scene: Scene, ro, rd, w, pix, accum):
    """One level of castRay for live rays: returns the accumulator with
    their radiance added and their children (ro, rd, w, pix)."""
    dt = scene.bg.dtype
    n_obj = len(scene.kinds)
    cols, mesh_rows = [], {}
    for oi, (kind, g) in enumerate(zip(scene.kinds, scene.geom)):
        if kind == "sphere":
            cols.append(sphere_t(ro, rd, g[0], g[1]))
        elif kind == "plane":
            cols.append(plane_t(ro, rd, g[0], g[1]))
        else:
            t, tri, u, v = mesh_hit(g, ro, rd, scene.culling)
            cols.append(t)
            mesh_rows[oi] = (tri, u, v)
    tmat = torch.stack(cols)
    obj = torch.argmin(tmat.detach(), 0)
    t = torch.gather(tmat, 0, obj[None])[0]
    hit = t < _big(t.dtype)

    miss = torch.nonzero(~hit).reshape(-1)
    accum = accum.index_add(0, pix[miss], w[miss][:, None] * scene.bg)
    sel = torch.nonzero(hit).reshape(-1)
    ro, rd, w, pix, t, obj = ro[sel], rd[sel], w[sel], pix[sel], t[sel], obj[sel]
    hp = ro + rd * t[:, None]
    q = ro.shape[0]

    normal = torch.zeros((q, 3), dtype=dt, device=ro.device)
    color = scene.color[obj]
    spec_coef = torch.tensor(scene.specular, dtype=dt, device=ro.device)[obj]
    for oi, (kind, g) in enumerate(zip(scene.kinds, scene.geom)):
        on = (obj == oi)[:, None]
        if kind == "sphere":
            normal = torch.where(on, normalize(hp - g[0]), normal)
        elif kind == "plane":
            normal = torch.where(on, g[1].expand(q, 3), normal)
        else:
            tri, u, v = (x[sel] for x in mesh_rows[oi])
            tri = torch.clamp_min(tri, 0)
            w0 = 1.0 - u - v
            nv, uvv = g.n[tri], g.uv[tri]
            tex = (uvv[:, 1] * u[:, None] + uvv[:, 2] * v[:, None]
                   + uvv[:, 0] * w0[:, None])
            nrm = normalize((nv[:, 1] * u[:, None] + nv[:, 2] * v[:, None]
                             + nv[:, 0] * w0[:, None]) / 3.0)
            if "normal" in g.maps:
                tn = normalize(sample(*g.maps["normal"], tex))
                nrm = normalize(tn[:, 0:1] * g.tangent[tri]
                                + tn[:, 1:2] * g.bitangent[tri]
                                + tn[:, 2:3] * nrm)
            normal = torch.where(on, nrm, normal)
            if "diffuse" in g.maps:
                color = torch.where(on, sample(*g.maps["diffuse"], tex), color)
            if "specular" in g.maps:
                spec_coef = torch.where(on[:, 0],
                                        sample(*g.maps["specular"], tex)[:, 0],
                                        spec_coef)

    def per_obj(vals):
        return torch.tensor(vals, dtype=dt, device=ro.device)[obj]

    nspec = per_obj(scene.nspec)
    shadow_o = hp + normal * scene.bias
    diff_c = torch.zeros((q, 3), dtype=dt, device=ro.device)
    spec_c = torch.zeros((q, 3), dtype=dt, device=ro.device)
    for li in scene.lights:
        if li["type"] == "distant":
            ldir = li["dir"].expand(q, 3)
            inten = (li["color"] * li["intensity"]).expand(q, 3)
            dist = torch.full((q,), _big(dt), dtype=dt, device=ro.device)
        else:
            delta = hp - li["pos"]
            d2 = dot(delta, delta)
            fall = torch.clamp_max(li["intensity"] / (
                4.0 * math.pi * torch.clamp_min(d2, 1e-30) / 1000.0), 1.0)
            inten = li["color"] * fall[:, None]
            ldir = normalize(delta)
            dist = torch.sqrt(d2)
        ndl = torch.clamp_min(dot(normal, -ldir), 0.0)
        spec_f = spec_pow(torch.clamp_min(dot(reflect(ldir, normal), -rd), 0.0),
                          nspec)
        need = torch.nonzero(((ndl > 0) | (spec_f > 0)).detach()).reshape(-1)
        vis = torch.zeros((q,), dtype=dt, device=ro.device)
        occ = occluded(scene, shadow_o[need].detach(), -ldir[need].detach(),
                       dist[need].detach())
        vis = vis.index_put((need,), (~occ).to(dt))
        diff_c = diff_c + inten * (vis * ndl)[:, None]
        spec_c = spec_c + (vis * spec_f)[:, None] * inten

    mat = [scene.mats[i] for i in range(n_obj)]
    is_m = {m: torch.tensor([x == m for x in mat], device=ro.device)[obj]
            for m in ("diffuse", "phong", "reflective", "transparent")}
    ior = per_obj(scene.ior)
    kr = fresnel(rd, normal, ior)
    hc = torch.where(
        is_m["diffuse"][:, None], color * diff_c,
        torch.where(is_m["phong"][:, None],
                    color * per_obj(scene.ambient)[:, None]
                    + diff_c * per_obj(scene.diffuse)[:, None]
                    + spec_c * spec_coef[:, None],
                    torch.where(is_m["reflective"][:, None], spec_c,
                                spec_c * kr[:, None])))
    accum = accum.index_add(0, pix, w[:, None] * hc)

    # Children: reflective -> one at 0.8 (direction not normalized);
    # transparent -> reflected at kr and refracted at 1 - kr.
    bias_v = scene.bias * normal
    rdn = dot(rd, normal)
    outside = (rdn < 0)[:, None]
    refl = torch.nonzero(is_m["reflective"]).reshape(-1)
    trans = torch.nonzero(is_m["transparent"]).reshape(-1)
    c_ro = [(hp + bias_v)[refl],
            torch.where(outside, hp + bias_v, hp - bias_v)[trans],
            torch.where(outside, hp - bias_v, hp + bias_v)[trans]]
    c_rd = [(rd - 2.0 * rdn[:, None] * normal)[refl],
            normalize(reflect(rd, normal))[trans],
            normalize(refract(rd, normal, ior))[trans]]
    c_w = [(w * 0.8)[refl], (w * kr)[trans],
           torch.where(kr < 1.0, w * (1.0 - kr), 0.0)[trans]]
    c_pix = [pix[refl], pix[trans], pix[trans]]
    cw = torch.cat(c_w)
    live = torch.nonzero(cw.detach() > 0).reshape(-1)
    return accum, (torch.cat(c_ro)[live], torch.cat(c_rd)[live], cw[live],
                   torch.cat(c_pix)[live])


def radiance(scene: Scene, ro, rd, w, pix, n_out: int):
    """(n_out, 3): the weighted radiance of the rays' path trees summed
    into their pixel slots pix."""
    accum = torch.zeros((n_out, 3), dtype=scene.bg.dtype, device=ro.device)
    n_bounces = scene.max_depth + 1 if scene.bouncing else 1
    for _ in range(n_bounces):
        if ro.shape[0] == 0:
            return accum
        accum, (ro, rd, w, pix) = bounce(scene, ro, rd, w, pix, accum)
    if scene.bouncing and ro.shape[0]:
        accum = accum.index_add(0, pix, w[:, None] * scene.bg)
    return accum


def sobel_mask(frame):
    """(H, W, 3) -> bool (H, W): sqrt(|gx|^2 + |gy|^2) > 0.5 with the
    RGB lengths of the 3x3 Sobel responses; borders False."""
    h, w = frame.shape[:2]
    s = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
    gx = torch.zeros((h - 2, w - 2, 3), dtype=frame.dtype, device=frame.device)
    gy = torch.zeros_like(gx)
    for a in range(3):
        for b in range(3):
            patch = frame[a:h - 2 + a, b:w - 2 + b]
            gx = gx + patch * s[a][b]
            gy = gy + patch * s[b][a]
    lx = torch.sqrt(dot(gx, gx))
    ly = torch.sqrt(dot(gy, gy))
    inner = torch.sqrt(lx * lx + ly * ly) > 0.5
    return torch.nn.functional.pad(inner, (1, 1, 1, 1), value=False)


def render(scene: Scene, *, target=None, block: int = BLOCK):
    """The frame (H, W, 3) in the scene's dtype. With `target` (H, W, 3)
    the pixel loss mean((frame - target)^2) is returned too, its
    gradients accumulated into the scene's leaf tensors block by block
    (SSAA is then off, as in a train step)."""
    w, h = scene.width, scene.height
    dev = scene.bg.device
    n = w * h
    live = ((torch.arange(h, device=dev)[:, None] < h - 1)
            & (torch.arange(w, device=dev)[None, :] < w - 1)).reshape(n)
    parts, loss = [], 0.0
    for s in range(0, n, block):
        ids = torch.arange(s, min(s + block, n), device=dev)
        ro, rd = camera_rays(scene, (ids % w).float(), (ids // w).float(),
                             1.0, 1.0)
        with torch.set_grad_enabled(target is not None):
            wt = torch.ones((ids.numel(),), dtype=scene.bg.dtype, device=dev)
            px = radiance(scene, ro, rd, wt,
                          torch.arange(ids.numel(), device=dev), ids.numel())
            px = torch.where(live[ids][:, None], px, 0.0)
            if target is not None:
                part = torch.sum((px.float() - target.reshape(n, 3)[ids]) ** 2
                                 ) / (3 * n)
                part.backward()
                loss += float(part.detach())
        parts.append(px.detach())
    frame = torch.cat(parts).reshape(h, w, 3)
    if target is not None:
        return frame, loss
    if scene.ssaa:
        frame = _ssaa(scene, frame, block)
    return frame


@torch.no_grad()
def _ssaa(scene: Scene, frame, block: int):
    w = scene.width
    mask = sobel_mask(frame)
    idx = torch.nonzero(mask.reshape(-1)).reshape(-1)
    out = frame.reshape(-1, 3).clone()
    sub = block // 4
    for s in range(0, idx.numel(), sub):
        ids = idx[s:s + sub]
        k = ids.numel()
        xs, ys = (ids % w).float(), (ids // w).float()
        rays = [camera_rays(scene, xs, ys, ox + 0.5, oy + 0.5)
                for ox, oy in ((0.25, 0.25), (0.25, 0.75), (0.75, 0.25),
                               (0.75, 0.75))]
        ro = torch.cat([r[0] for r in rays])
        rd = torch.cat([r[1] for r in rays])
        wt = torch.full((4 * k,), 0.25, dtype=frame.dtype, device=frame.device)
        px = radiance(scene, ro, rd, wt,
                      torch.arange(k, device=frame.device).repeat(4), k)
        out[ids] = px
    return out.reshape(frame.shape)


def quantize(frame) -> np.ndarray:
    """(H, W, 3) -> u8 as the engine writes a BMP: clamp to [0, 1], times
    255, truncated; a value of 255 or more is written as 127."""
    p = torch.clamp(frame.float(), 0.0, 1.0) * 255.0
    u8 = torch.where(p >= 255.0, 127.0, torch.floor(p))
    return u8.to(torch.uint8).cpu().numpy()
