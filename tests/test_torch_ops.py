"""Port parity: each ported op of rendering_tpu_torch against its JAX
function in rendering_tpu, on the same seeded numpy inputs, on the CPU.

Tolerance: exact where the JAX package pins bits (indices, texel
lookups, quantization, host numpy), else rtol=1e-6, atol=1e-7 (XLA may
fuse or reorder an f32 expression the port evaluates op by op).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendering_tpu.accel import bvh as j_bvh
from rendering_tpu.flagship import build_flagship_scene as j_flagship
from rendering_tpu.flagship import procedural_mesh as j_procedural_mesh
from rendering_tpu.models import objloader as j_objloader
from rendering_tpu.models import parser as j_parser
from rendering_tpu.ops import geometry as j_geom
from rendering_tpu.ops import intersect as j_isect
from rendering_tpu.ops import shading as j_shading
from rendering_tpu.ops import skybox as j_skybox
from rendering_tpu.ops import texture as j_texture
from rendering_tpu.render import pipeline as j_pipeline
from rendering_tpu.render import raygen as j_raygen
from rendering_tpu_torch.accel import bvh as t_bvh
from rendering_tpu_torch.flagship import procedural_mesh as t_procedural_mesh
from rendering_tpu_torch.models import objloader as t_objloader
from rendering_tpu_torch.models import parser as t_parser
from rendering_tpu_torch.ops import geometry as t_geom
from rendering_tpu_torch.ops import intersect as t_isect
from rendering_tpu_torch.ops import shading as t_shading
from rendering_tpu_torch.ops import skybox as t_skybox
from rendering_tpu_torch.ops import texture as t_texture
from rendering_tpu_torch.render import pipeline as t_pipeline
from rendering_tpu_torch.render import raygen as t_raygen
from rendering_tpu_torch.utils import bmp as t_bmp
from rendering_tpu.utils import bmp as j_bmp
from torch_port_util import port_scene

RTOL, ATOL = 1e-6, 1e-7


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)


def _equal(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _both(*arrays):
    """Each numpy array as (jnp array, torch tensor)."""
    return [(jnp.asarray(a), torch.from_numpy(np.array(a))) for a in arrays]


def _rows(rng, n, scale=1.0):
    return rng.normal(0, scale, (3, n)).astype(np.float32)


# ---- geometry -----------------------------------------------------------


@pytest.mark.parametrize("name", ["dot_r", "cross_r", "normalize_r"])
def test_geometry_rows(name):
    rng = np.random.default_rng(0)
    a = _rows(rng, 500)
    b = _rows(rng, 500)
    a[:, :3] = 0.0  # zero vectors stay unchanged under normalize
    (ja, ta), (jb, tb) = _both(a, b)
    jf, tf = getattr(j_geom, name), getattr(t_geom, name)
    if name == "normalize_r":
        _close(jf(ja), tf(ta))
        _equal(tf(ta)[:, :3], a[:, :3])
    else:
        _close(jf(ja, jb), tf(ta, tb))


def test_normalize_last_axis():
    rng = np.random.default_rng(1)
    a = rng.normal(0, 3, (400, 3)).astype(np.float32)
    a[0] = 0.0
    (ja, ta), = _both(a)
    _close(j_geom.normalize(ja), t_geom.normalize(ta))


# ---- intersection tests ---------------------------------------------------


def test_spheres_r():
    rng = np.random.default_rng(2)
    n = 800
    ro = _rows(rng, n, 2.0)
    rd = t_geom.normalize_r(torch.from_numpy(_rows(rng, n))).numpy()
    pos = rng.normal(0, 2, (4, 3)).astype(np.float32)
    rad = rng.uniform(0.3, 1.5, 4).astype(np.float32)
    (jro, tro), (jrd, trd), (jp, tp), (jr, tr) = _both(ro, rd, pos, rad)
    jt = j_isect.intersect_spheres_r(jro, jrd, jp, jr)
    tt = t_isect.intersect_spheres_r(tro, trd, tp, tr)
    assert (tt.numpy() < 3e38).sum() > 20  # some rays hit
    _close(jt, tt)


def test_sphere_tangency_is_finite_and_equal():
    """An exactly tangent ray (d2 == r2) keeps its primal thc = 0 and a
    finite gradient, as the JAX double-where does."""
    ro = np.array([[0.0], [1.0], [5.0]], np.float32)
    rd = np.array([[0.0], [0.0], [-1.0]], np.float32)
    pos = np.zeros((1, 3), np.float32)
    rad = np.ones((1,), np.float32)
    (jro, tro), (jrd, trd), (jp, tp), (jr, tr) = _both(ro, rd, pos, rad)
    jt = j_isect.intersect_spheres_r(jro, jrd, jp, jr)
    tr.requires_grad_(True)
    tt = t_isect.intersect_spheres_r(tro, trd, tp, tr)
    _equal(jt, tt.detach())
    assert float(tt.detach()[0, 0]) == 5.0
    tt.sum().backward()
    assert torch.isfinite(tr.grad).all()


def test_planes_r():
    rng = np.random.default_rng(3)
    n = 600
    ro = _rows(rng, n, 2.0)
    rd = _rows(rng, n)
    rd[:, :5] = np.array([1.0, 0.0, 0.0], np.float32)[:, None]  # parallel
    pos = rng.normal(0, 1, (3, 3)).astype(np.float32)
    nrm = np.array([[0, 1, 0], [0.3, 0.2, 1], [1, 0, 0]], np.float32)
    (jro, tro), (jrd, trd), (jp, tp), (jn, tn) = _both(ro, rd, pos, nrm)
    _close(j_isect.intersect_planes_r(jro, jrd, jp, jn),
           t_isect.intersect_planes_r(tro, trd, tp, tn))


@pytest.mark.parametrize("backface_culling", [True, False])
def test_ray_triangle_r(backface_culling):
    rng = np.random.default_rng(4)
    n = 2000
    ro = _rows(rng, n, 0.3)
    v0 = _rows(rng, n) + np.array([[0], [0], [-3]], np.float32)
    v1 = v0 + _rows(rng, n)
    v2 = v0 + _rows(rng, n)
    rd = (v0 + v1 + v2) / 3 - ro + _rows(rng, n, 0.3)
    args = _both(ro, rd, v0, v1, v2)
    jt, ju, jv, jok = j_isect.ray_triangle_r(*[a for a, _ in args],
                                             backface_culling)
    tt, tu, tv, tok = t_isect.ray_triangle_r(*[b for _, b in args],
                                             backface_culling)
    assert int(tok.sum()) > 100
    _equal(jok, tok)
    _close(jt, tt)
    _close(ju, tu)
    _close(jv, tv)


# ---- shading ---------------------------------------------------------------


def test_reflect_r():
    rng = np.random.default_rng(5)
    (jd, td), (jn, tn) = _both(_rows(rng, 300), _rows(rng, 300))
    _close(j_shading.reflect_r(jd, jn), t_shading.reflect_r(td, tn))


def test_spec_pow():
    rng = np.random.default_rng(6)
    base = rng.uniform(-0.5, 1.0, 1000).astype(np.float32)
    base[:10] = 0.0
    ex = rng.uniform(1.0, 50.0, 1000).astype(np.float32)
    (jb, tb), (je, te) = _both(base, ex)
    out = t_shading.spec_pow(tb, te)
    _close(j_shading.spec_pow(jb, je), out)
    assert (out.numpy()[base <= 0] == 0).all()


def _refraction_cases():
    """(d3, n3, ior) rows: random incidences from both sides of the
    surface, then a total internal reflection, the exact critical angle
    (k == 0: cos^2 = 0.75 exactly in f32, ior 2 from inside) and head-on
    hits from both sides."""
    rng = np.random.default_rng(8)
    d = _rows(rng, 400)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    n = _rows(rng, 400)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    ior = rng.uniform(1.0, 2.0, 400).astype(np.float32)
    c = np.float32(np.sqrt(0.75))
    while np.float32(c * c) != np.float32(0.75):
        c = np.nextafter(c, np.float32(1))
    special = np.asarray([
        # d (3), n (3), ior: TIR from inside, the critical angle, head-on
        # from outside and from inside
        [0.9, 0.0, 0.43589, 0, 0, 1, 1.5],
        [0.5, 0.0, c, 0, 0, 1, 2.0],
        [0, 0, -1, 0, 0, 1, 1.4],
        [0, 0, 1, 0, 0, 1, 1.4],
    ], np.float32).T
    d = np.concatenate([d, special[0:3]], axis=1)
    n = np.concatenate([n, special[3:6]], axis=1)
    ior = np.concatenate([ior, special[6]])
    return d, n, ior


def test_refract_fresnel_r():
    """refract_r and fresnel_r against JAX on both sides of the surface,
    with TIR (k < 0: the zero vector, kr = 1), the exact critical angle
    (k == 0 refracts) and head-on hits; gradients with respect to the
    direction, the normal and the ior finite everywhere and equal to
    jax.grad's."""
    d, n, ior = _refraction_cases()
    (jd, td), (jn, tn), (ji, tior) = _both(d, n, ior)
    j_refr = j_shading.refract_r(jd, jn, ji)
    t_refr = t_shading.refract_r(td, tn, tior)
    _close(j_refr, t_refr)
    _close(j_shading.fresnel_r(jd, jn, ji), t_shading.fresnel_r(td, tn, tior))
    tir, crit, front, back = (slice(-4 + i, None if i == 3 else -3 + i)
                              for i in range(4))
    assert (t_refr[:, tir] == 0).all() and t_shading.fresnel_r(
        td, tn, tior)[tir].item() == 1.0
    assert (t_refr[:, crit] != 0).any()  # k == 0 refracts
    assert 0 < t_shading.fresnel_r(td, tn, tior)[front].item() < 1
    assert 0 < t_shading.fresnel_r(td, tn, tior)[back].item() < 1
    for fn in ("refract_r", "fresnel_r"):
        def j_loss(a, b, c, fn=fn):
            return jnp.sum(getattr(j_shading, fn)(a, b, c))

        jg = jax.grad(j_loss, argnums=(0, 1, 2))(jd, jn, ji)
        args = [x.clone().requires_grad_(True) for x in (td, tn, tior)]
        getattr(t_shading, fn)(*args).sum().backward()
        for j, t in zip(jg, args):
            assert torch.isfinite(t.grad).all(), fn
            np.testing.assert_allclose(_np(t.grad), np.asarray(j), rtol=1e-5,
                                       atol=1e-5)


def test_morton_key_r():
    """Bit-equal to the JAX uint32 key, a degenerate axis (span 0)
    included; every key fits 30 bits."""
    rng = np.random.default_rng(9)
    p = _rows(rng, 2000, scale=3.0)
    flat = p.copy()
    flat[1] = 0.5  # one axis without extent
    for pts in (p, flat):
        (jp, tp), = _both(pts)
        key = t_geom.morton_key_r(tp)
        assert key.dtype == torch.int64 and int(key.max()) < 2 ** 30
        _equal(key, np.asarray(j_geom.morton_key_r(jp)).astype(np.int64))
    assert t_geom.MORTON_INACTIVE == 0xFFFFFFFF


# ---- texture and skybox ------------------------------------------------------

# Texture coordinates in and far out of range, and non-finite values: the
# port must reproduce JAX's saturating convert, int32 wrap and gather clamp.
_ODD_TEX = np.array(
    [-0.5, -1.0, -3.7, 1.0, 1.5, 7.0, -1e9, 1e9, 3e9, -3e9, np.nan,
     np.inf, -np.inf, 0.999999, 0.0, -0.0], np.float32)


def _tex2(seed, n=1500):
    rng = np.random.default_rng(seed)
    tex = rng.uniform(-0.2, 1.2, (2, n)).astype(np.float32)
    k = len(_ODD_TEX)
    tex[0, :k] = _ODD_TEX
    tex[1, k:2 * k] = _ODD_TEX
    tex[:, 2 * k:3 * k] = _ODD_TEX
    return tex


@pytest.mark.parametrize("wh", [(16, 8), (13, 7)])
@pytest.mark.parametrize("fn", ["sample_map_r", "sample_map_bilinear_r"])
@pytest.mark.parametrize("channels", [3, 1, 0])
def test_sample_map(wh, fn, channels):
    rng = np.random.default_rng(7)
    n_tex = wh[0] * wh[1]
    shape = (n_tex,) if channels == 0 else (n_tex, channels)
    flat = rng.uniform(0, 1, shape).astype(np.float32)
    (jm, tm), (jt, tt) = _both(flat, _tex2(8))
    j_out = getattr(j_texture, fn)(jm, wh, jt)
    t_out = getattr(t_texture, fn)(tm, wh, tt)
    if fn == "sample_map_r":
        _equal(j_out, t_out)  # a pure texel lookup
    else:
        finite = np.isfinite(_np(j_out))
        _equal(finite, np.isfinite(_np(t_out)))
        _close(_np(j_out)[finite], _np(t_out)[finite])


@pytest.mark.parametrize("fn", ["sample_packed_r", "sample_packed_bilinear_r"])
def test_sample_packed(fn):
    rng = np.random.default_rng(9)
    wh = (16, 8)
    maps = rng.uniform(0, 1, (7, wh[0] * wh[1])).astype(np.float32)
    (jm, tm), (jt, tt) = _both(maps, _tex2(10))
    j_out = getattr(j_texture, fn)(jm, wh, jt)
    t_out = getattr(t_texture, fn)(tm, wh, tt)
    if fn == "sample_packed_r":
        _equal(j_out, t_out)
    else:
        finite = np.isfinite(_np(j_out))
        _close(_np(j_out)[finite], _np(t_out)[finite])


def test_skybox_r():
    rng = np.random.default_rng(11)
    sky = rng.uniform(0, 1, (6, 12, 16, 3)).astype(np.float32)
    d = _rows(rng, 2000)
    # Ties between axes exercise the ladder order (z, then x, else y).
    d[:, :6] = np.array([[1, 1, 1], [1, 0, 1], [1, 1, 0], [0, 1, 1],
                         [-1, -1, 0], [0, 0, 0]], np.float32).T
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    (js, ts), (jd, td), (jb, tb) = _both(sky, d, bg)
    _equal(j_skybox.sample_skybox_r(js, jd, jb),
           t_skybox.sample_skybox_r(ts, td, tb))
    _equal(j_skybox.sample_skybox_r(None, jd, jb),
           t_skybox.sample_skybox_r(None, td, tb))


# ---- ray generation and quantization ------------------------------------------


@pytest.fixture(scope="module")
def flagship_pair():
    js = j_flagship(64, 32, n_tris=500, with_maps=False)
    return js, port_scene(js)


@pytest.mark.parametrize("offset", [1.0, 0.5])
def test_primary_rays(flagship_pair, offset):
    js, ts = flagship_pair
    jro, jrd, jpix = j_raygen.primary_rays(js, offset)
    tro, trd, tpix = t_raygen.primary_rays(ts, offset)
    _equal(jpix, tpix)
    _equal(jro, tro)
    _close(jrd, trd)


@pytest.mark.parametrize("wh", [(64, 32), (3840, 1080), (123, 45), (1, 1)])
def test_tile_dims(wh):
    assert j_raygen.tile_dims(*wh) == t_raygen.tile_dims(*wh)


def test_quantize_u8():
    rng = np.random.default_rng(12)
    f = rng.uniform(-0.5, 1.5, (3, 20, 30)).astype(np.float32)
    f[0, 0, :6] = [1.0, 254.9999 / 255, 0.0, -0.0, 1e-9, 255.0 / 255]
    (jf, tf), = _both(f)
    out = t_pipeline.quantize_u8(tf)
    _equal(j_pipeline.quantize_u8(jf), out)
    _equal(out, t_bmp.quantize_reference(f.transpose(1, 2, 0)))


# ---- host-side copies (numpy) ---------------------------------------------------


@pytest.mark.parametrize("n_tris", [128, 777, 2000, 2001])
def test_procedural_mesh_and_morton(n_tris):
    a = j_procedural_mesh(n_tris, pos=(-0.1, 0, -0.6), size=(2, 2, 2), seed=1)
    b = t_procedural_mesh(n_tris, pos=(-0.1, 0, -0.6), size=(2, 2, 2), seed=1)
    for k in ("v", "n", "uv", "tangent", "bitangent", "root_bounds"):
        _equal(getattr(a, k), getattr(b, k))
    _equal(j_bvh.morton_order(a.v), t_bvh.morton_order(b.v))


@pytest.mark.parametrize("rot", [(0, 0, 0), (0, 100, 0), (12.5, -33, 71)])
def test_euler_matrix(rot):
    _equal(j_objloader.euler_matrix(rot), t_objloader.euler_matrix(rot))


def test_map_decoders():
    rng = np.random.default_rng(13)
    flat = (rng.integers(0, 256, (64, 3)) / 256.0).astype(np.float32)
    _equal(j_parser.decode_normal_map(flat.copy()),
           t_parser.decode_normal_map(flat.copy()))
    _equal(j_parser.decode_specular_map(flat), t_parser.decode_specular_map(flat))


def test_bmp_roundtrip():
    rng = np.random.default_rng(14)
    img = rng.uniform(0, 1.2, (5, 7, 3)).astype(np.float32)
    assert t_bmp.encode_bmp(img) == j_bmp.encode_bmp(img)
    _equal(t_bmp.decode_bmp(t_bmp.encode_bmp(img)),
           j_bmp.decode_bmp(j_bmp.encode_bmp(img)))
