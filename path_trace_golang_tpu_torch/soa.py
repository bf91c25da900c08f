"""Scene -> SoA tensors, with the layouts of ``path_trace_golang_tpu/soa.py``.

* material stride 20 floats (gpu.go:402-406, packer gpu.go:1829-1913):
  ``[typ, rough, ior, smoothness, albedo.rgb, reflectivity,
  emit.rgb, pad, absorption.rgb, absorption_scale, tint.rgb, pad]``
* object stride 12 floats (gpu.go:411-416, packer gpu.go:1915-1968):
  ``[type, matIndex, pad, pad, pos.xyz, pad, size.xyz, pad]``
* light index list = indices of emissive objects with nonzero emit
* camera / sky / fog blocks of 16 floats (gpu.go:1970-2104)
* triangles (<= ``STATIC_TRI_MAX``): one 24-float row per BVH-ordered
  triangle ``[v0, e1, e2, mat_idx, obj_idx, smooth, n0, n1, n2, pad]``
  plus ``LEAF_SIZE`` zero rows, and f32[B,6] node bounds.
* triangles above that: the paged layout of ``ops/bvh.py``, page tiles
  f32[P,128,32] and entry-test boxes f32[P,k,6]; ``tri`` and
  ``bvh_bounds`` are then one zero row each.

The tables are built with NumPy exactly as the JAX package builds them and
then moved to the requested device.  :func:`pack_from_numpy` carries a
pack that the JAX package built (its arrays through ``np.asarray``, its
static fields as they are) into this package.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from .ops.bvh import (
    LEAF_SIZE, N_PAGE_ATTRS, N_SUB_BOXES, PAGE_TRIS, BvhTopology, PagedBvh, build_bvh,
    build_paged_bvh, page_boxes_table, use_dynamic_walk,
)
from .scene.model import Scene
from .utils.config import switch_on
from .utils.metrics import count, span

__all__ = [
    "ScenePack",
    "pack_scene",
    "pack_from_numpy",
    "MAT_LAMBERT",
    "MAT_METAL",
    "MAT_DIELECTRIC",
    "MAT_EMISSIVE",
    "MAT_MIRROR",
    "OBJ_SPHERE",
    "OBJ_PLANE",
    "OBJ_BOX",
    "MAT_STRIDE",
    "OBJ_STRIDE",
    "ARRAY_FIELDS",
    "STATIC_FIELDS",
    "resolve_device",
]

MAT_LAMBERT = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_EMISSIVE = 3
MAT_MIRROR = 4

OBJ_SPHERE = 0
OBJ_PLANE = 1
OBJ_BOX = 2

MAT_STRIDE = 20
OBJ_STRIDE = 12

_MAT_CODE = {
    "lambert": MAT_LAMBERT,
    "metal": MAT_METAL,
    "dielectric": MAT_DIELECTRIC,
    "emissive": MAT_EMISSIVE,
    "mirror": MAT_MIRROR,
}
_OBJ_CODE = {
    "sphere": OBJ_SPHERE,
    "sphere_light": OBJ_SPHERE,
    "plane": OBJ_PLANE,
    "box": OBJ_BOX,
}

# the arrays that a pack of the JAX package has under the same names;
# ``page_boxes`` is this package's own table, derived from ``paged``
ARRAY_FIELDS = ("mat", "obj", "light_idx", "cam", "sky", "fog", "tri", "bvh_bounds", "page_tiles")
STATIC_FIELDS = (
    "n_objects", "n_materials", "n_lights", "obj_types", "obj_mats", "light_objs",
    "mat_types", "mat_uniform", "n_triangles", "tri_mats", "tri_smooth", "bvh", "paged", "lens_disk",
)

# paged build products keyed by triangle content and device: re-rendering
# the same mesh (camera or light edits) reuses the tensors on the device
_BVH_BUILD_CACHE: dict = {}


@dataclasses.dataclass(frozen=True)
class ScenePack:
    """Device-resident SoA scene; tuples and counts are static topology."""

    mat: torch.Tensor  # f32[M, 20]
    obj: torch.Tensor  # f32[N, 12]
    light_idx: torch.Tensor  # i32[max(L,1)]
    cam: torch.Tensor  # f32[16]
    sky: torch.Tensor  # f32[16]
    fog: torch.Tensor  # f32[16]
    n_objects: int
    n_materials: int
    n_lights: int
    obj_types: tuple = ()
    obj_mats: tuple = ()
    light_objs: tuple = ()
    mat_types: tuple = ()
    # per material column, its value where every material has the same one, else None (JAX soa.py:510-518,
    # where it prunes the select chains of the closest hit); () after PATHTRACER_NO_MAT_UNIFORM_PRUNE=1 is
    # (None,) * MAT_STRIDE.  No kernel and no plain version reads it: a CUDA thread reads its hit's material row,
    # and the plain version gathers the winner's row (ops/geometry.py).
    mat_uniform: tuple = ()
    tri: Optional[torch.Tensor] = None  # f32[max(T,1)+LEAF_SIZE, 24]
    bvh_bounds: Optional[torch.Tensor] = None  # f32[max(B,1), 6]
    n_triangles: int = 0
    tri_mats: tuple = ()
    tri_smooth: tuple = ()
    bvh: Optional[BvhTopology] = None
    page_tiles: Optional[torch.Tensor] = None  # f32[max(P,1), 128, 32]
    page_boxes: Optional[torch.Tensor] = None  # f32[max(P,1), k, 6]
    paged: Optional[PagedBvh] = None
    lens_disk: bool = False
    _host: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def device(self) -> torch.device:
        return self.mat.device

    @property
    def tri_any_emissive(self) -> bool:
        """Whether any mesh triangle carries an emissive material.  When
        none does, a ``lite`` mesh query can only find the mesh as an
        occluder of the object sweep's winner (ops/geometry.py).  Found once
        a pack: a mesh's triangles are many, and every launch asks."""
        if "tri_any_emissive" not in self._host:
            self._host["tri_any_emissive"] = any(self.mat_types[mi] == MAT_EMISSIVE for mi in set(self.tri_mats))
        return self._host["tri_any_emissive"]

    def host(self, name: str) -> np.ndarray:
        """A NumPy copy of one table, read once: the plain versions take
        their per-object constants from it as float32 scalars."""
        if name not in self._host:
            self._host[name] = getattr(self, name).cpu().numpy()
        return self._host[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch version on the CPU"
        )
    return dev


def _clamp(x: float, lo: float, hi: float) -> float:
    return lo if x < lo else hi if x > hi else x


def _mesh_blocks(sc: Scene, mat_index):
    """Per-object (F,3) triangle blocks, concatenated (soa.py:356-412)."""
    v0b, e1b, e2b, matb, smoothb, vnb = [], [], [], [], [], []
    for o in sc.objects:
        midx = mat_index.get(o.material_id, 0)
        if o.type == "triangle" and o.vertices and len(o.vertices) >= 3:
            a, b, c = (np.array(v.as_tuple(), np.float64) for v in o.vertices[:3])
            v0b.append(a[None])
            e1b.append((b - a)[None])
            e2b.append((c - a)[None])
            matb.append(np.full((1,), midx, np.int64))
            smoothb.append(np.zeros((1,), bool))
            vnb.append(np.zeros((1, 3, 3), np.float64))
        elif o.type == "mesh" and o.mesh:
            verts = np.asarray(o.mesh.get("vertices", []), np.float64)
            faces = np.asarray(o.mesh.get("faces", []), np.int64)
            if verts.size == 0 or faces.size == 0:
                continue
            scale = np.array([s if s != 0 else 1.0 for s in o.size.as_tuple()], np.float64)
            verts = verts * scale + np.array(o.position.as_tuple(), np.float64)
            smooth = bool(o.mesh.get("smooth", False))
            fa, fb, fc = faces[:, 0], faces[:, 1], faces[:, 2]
            a, b, c = verts[fa], verts[fb], verts[fc]
            nf = faces.shape[0]
            v0b.append(a)
            e1b.append(b - a)
            e2b.append(c - a)
            matb.append(np.full((nf,), midx, np.int64))
            smoothb.append(np.full((nf,), smooth, bool))
            if smooth:
                fn = np.cross(b - a, c - a)
                vert_n = np.zeros_like(verts)
                np.add.at(vert_n, fa, fn)
                np.add.at(vert_n, fb, fn)
                np.add.at(vert_n, fc, fn)
                norms = np.linalg.norm(vert_n, axis=1, keepdims=True)
                vert_n = vert_n / np.maximum(norms, 1e-20)
                vnb.append(np.stack([vert_n[fa], vert_n[fb], vert_n[fc]], axis=1))
            else:
                vnb.append(np.zeros((nf, 3, 3), np.float64))
    if not v0b:
        return 0, None
    cat = np.concatenate
    return sum(b.shape[0] for b in v0b), (cat(v0b), cat(e1b), cat(e2b), cat(matb), cat(smoothb), cat(vnb))


def pack_scene(sc: Scene, width: int = 0, height: int = 0, device="cuda") -> ScenePack:
    """Pack a :class:`Scene` into SoA tensors on ``device`` (gpu.go:1813-2104).

    ``width``/``height`` feed the camera-aspect fallback (gpu.go:1972-1975).
    """
    device = resolve_device(device)
    m_count = len(sc.materials)
    mat = np.zeros((max(m_count, 1), MAT_STRIDE), dtype=np.float32)
    for i, m in enumerate(sc.materials):
        typ = _MAT_CODE.get(m.type, MAT_LAMBERT)
        mat[i, 0] = typ
        mat[i, 1] = m.rough
        mat[i, 2] = m.ior
        smoothness = m.smoothness
        if smoothness == 0 and typ == MAT_METAL:
            smoothness = 1.0 - m.rough
        mat[i, 3] = _clamp(smoothness, 0.0, 1.0)
        mat[i, 4:7] = m.albedo.as_tuple()
        reflectivity = m.reflectivity
        if reflectivity == 0 and typ == MAT_METAL:
            reflectivity = 1.0
        mat[i, 7] = _clamp(reflectivity, 0.0, 1.0)
        mat[i, 8] = m.emit.r * m.power
        mat[i, 9] = m.emit.g * m.power
        mat[i, 10] = m.emit.b * m.power
        mat[i, 12:15] = m.absorption.as_tuple()
        absorption_scale = m.absorption_scale
        if absorption_scale == 0 and typ == MAT_DIELECTRIC:
            absorption_scale = 0.01
        mat[i, 15] = absorption_scale
        tr, tg, tb = m.tint.as_tuple()
        if tr == 0 and tg == 0 and tb == 0 and typ == MAT_DIELECTRIC:
            tr = tg = tb = 1.0
        mat[i, 16], mat[i, 17], mat[i, 18] = tr, tg, tb

    solid_objects = [o for o in sc.objects if o.type not in ("triangle", "mesh")]
    o_count = len(solid_objects)
    obj = np.zeros((max(o_count, 1), OBJ_STRIDE), dtype=np.float32)
    mat_index = sc.material_index()
    light_list = []
    for i, o in enumerate(solid_objects):
        obj[i, 0] = _OBJ_CODE.get(o.type, OBJ_SPHERE)
        midx = mat_index.get(o.material_id, 0)
        obj[i, 1] = midx
        obj[i, 4:7] = o.position.as_tuple()
        obj[i, 8:11] = o.size.as_tuple()
        if midx < m_count:
            m = sc.materials[midx]
            if m.type == "emissive" and (m.emit.r > 0 or m.emit.g > 0 or m.emit.b > 0):
                light_list.append(i)

    n_lights = len(light_list)
    light_idx = np.zeros((max(n_lights, 1),), dtype=np.int32)
    light_idx[:n_lights] = light_list

    cam_block = np.zeros((16,), dtype=np.float32)
    c = sc.camera
    aspect = c.aspect_ratio
    if aspect == 0 and width > 0 and height > 0:
        aspect = float(width) / float(height)
    cam_block[0:3] = c.position.as_tuple()
    cam_block[4:7] = c.target.as_tuple()
    cam_block[8:11] = c.up.as_tuple()
    cam_block[12] = c.fov
    cam_block[13] = c.aperture
    cam_block[14] = c.focus_dist
    cam_block[15] = aspect

    sky_block = np.zeros((16,), dtype=np.float32)
    if sc.sky is not None:
        if sc.sky.type == "gradient":
            sky_block[0] = 2.0
            sky_block[8:11] = sc.sky.horizon.as_tuple()
            sky_block[12:15] = sc.sky.zenith.as_tuple()
        else:
            sky_block[0] = 1.0
            sky_block[4:7] = sc.sky.color.as_tuple()
    else:
        sky_block[0] = 0.0
        sky_block[4:7] = sc.background.as_tuple()

    fog_block = np.zeros((16,), dtype=np.float32)
    fog_block[12] = 4.0
    fog_block[13] = 3.0
    f = sc.fog
    if f is not None:
        density = f.density if f.density > 0 else 0.0
        scatter = f.scatter if f.scatter > 0 else (1.0 if density > 0 else 0.0)
        fog_block[0] = density
        fog_block[1] = scatter
        fog_block[2] = 1.0 if f.affect_sky else 0.0
        fog_block[3] = 1.0 if f.gpu_volumetric else 0.0
        fog_block[4:7] = f.color.as_tuple()
        fog_block[7] = 1.0
        if f.sigma_s > 0 or f.sigma_a > 0:
            fog_block[8] = f.sigma_s
            fog_block[9] = f.sigma_a
        elif density > 0:
            s_mul = _clamp(scatter, 0.0, 1.0)
            sigma_s = density * s_mul
            fog_block[8] = sigma_s
            fog_block[9] = max(density - sigma_s, 0.0)
        fog_block[10] = _clamp(f.g, -0.9, 0.9)
        if f.hetero_strength > 0:
            fog_block[11] = min(f.hetero_strength, 1.0)
        if f.noise_scale > 0:
            fog_block[12] = f.noise_scale
        if f.noise_octaves > 0:
            fog_block[13] = min(f.noise_octaves, 5)

    t_count, blocks = _mesh_blocks(sc, mat_index)
    if o_count + t_count >= 2**24:
        raise ValueError(
            f"scene has {o_count + t_count} objects+triangles; float32 index "
            "columns in the triangle tables are exact only below 2^24"
        )
    topo = None
    paged, paged_tables = None, {}
    bvh_bounds = np.zeros((1, 6), np.float32)
    tri_rows = np.zeros((1, 24), np.float32)
    tri_mat_list, tri_smooth_list = np.zeros((0,), np.int64), np.zeros((0,), bool)
    if t_count:
        v0, e1, e2, tri_mat_list, tri_smooth_list, tri_vn = blocks
    if t_count and use_dynamic_walk(t_count):
        tri_obj = np.arange(o_count, o_count + t_count, dtype=np.int64)
        with span("pack.digest"):
            key = hashlib.sha1(str(device).encode())
            for arr in (v0, e1, e2, tri_mat_list, tri_obj, tri_smooth_list, tri_vn):
                key.update(np.ascontiguousarray(arr).tobytes())
            key = key.hexdigest()
        cached = _BVH_BUILD_CACHE.pop(key, None)
        if cached is None:
            count("bvh_cache_misses")
            with span("pack.bvh_build"):
                paged, tiles_np, _page_bbox = build_paged_bvh(
                    v0, e1, e2, tri_mat_list, tri_obj, tri_smooth_list, tri_vn
                )
                cached = (
                    paged,
                    torch.from_numpy(tiles_np).to(device),
                    torch.from_numpy(page_boxes_table(paged)).to(device),
                )
            if len(_BVH_BUILD_CACHE) >= 4:  # scenes are few
                _BVH_BUILD_CACHE.pop(next(iter(_BVH_BUILD_CACHE)))
        else:
            count("bvh_cache_hits")
        _BVH_BUILD_CACHE[key] = cached  # newest last
        paged = cached[0]
        paged_tables = dict(page_tiles=cached[1], page_boxes=cached[2])
    elif t_count:
        topo, bvh_bounds = build_bvh(v0, e1, e2)
        tri_rows = np.zeros((t_count + LEAF_SIZE, 24), np.float32)
        for bvh_i, orig in enumerate(topo.order):
            tri_rows[bvh_i, 0:3] = v0[orig]
            tri_rows[bvh_i, 3:6] = e1[orig]
            tri_rows[bvh_i, 6:9] = e2[orig]
            tri_rows[bvh_i, 9] = float(tri_mat_list[orig])
            tri_rows[bvh_i, 10] = float(o_count + orig)
            if tri_smooth_list[orig]:
                n0, n1, n2 = tri_vn[orig]
                tri_rows[bvh_i, 11] = 1.0
                tri_rows[bvh_i, 12:15] = n0
                tri_rows[bvh_i, 15:18] = n1
                tri_rows[bvh_i, 18:21] = n2

    arrays = dict(
        mat=mat, obj=obj, light_idx=light_idx, cam=cam_block, sky=sky_block,
        fog=fog_block, tri=tri_rows, bvh_bounds=bvh_bounds, **paged_tables,
    )
    static = dict(
        n_objects=o_count,
        n_materials=m_count,
        n_lights=n_lights,
        obj_types=tuple(int(t) for t in obj[:o_count, 0]) if o_count else (),
        obj_mats=tuple(int(m) for m in obj[:o_count, 1]) if o_count else (),
        light_objs=tuple(int(i) for i in light_list),
        mat_types=tuple(int(t) for t in mat[:m_count, 0]) if m_count else (),
        mat_uniform=tuple(
            float(mat[0, c]) if bool(np.all(mat[:, c] == mat[0, c])) else None
            for c in range(MAT_STRIDE)
        )
        if not switch_on("PATHTRACER_NO_MAT_UNIFORM_PRUNE")
        else (None,) * MAT_STRIDE,
        n_triangles=t_count,
        tri_mats=tuple(tri_mat_list),
        tri_smooth=tuple(tri_smooth_list),
        bvh=topo,
        paged=paged,
        lens_disk=(getattr(sc.camera, "lens", "ball") == "disk"),
    )
    with span("pack.upload"):
        return pack_from_numpy(arrays, static, device=device)


def pack_from_numpy(arrays: dict, static: dict, device="cuda") -> ScenePack:
    """Build a pack on ``device`` from NumPy arrays and static fields.

    ``arrays`` maps each name of ARRAY_FIELDS to an array (for example
    ``np.asarray`` of the same field of a JAX ``ScenePack``) or to a tensor
    that is already on ``device``; other keys are ignored.  ``page_tiles``
    may be left out of a pack without pages, and ``page_boxes`` always: it
    is then derived from ``paged``.  ``static`` maps the names of
    STATIC_FIELDS to their values; ``bvh`` may be any object with
    ``miss``/``first``/``count``/``order`` sequences and ``paged`` any
    object with the fields of :class:`PagedBvh`.
    """
    device = resolve_device(device)
    dtypes = dict(light_idx=torch.int32)

    paged = static.get("paged")
    if paged is not None and not isinstance(paged, PagedBvh):
        paged = PagedBvh(**{f.name: getattr(paged, f.name) for f in dataclasses.fields(PagedBvh)})
    arrays = dict(arrays)
    if paged is None:
        arrays["page_tiles"] = np.zeros((1, PAGE_TRIS, N_PAGE_ATTRS), np.float32)
        arrays["page_boxes"] = np.zeros((1, N_SUB_BOXES, 6), np.float32)
    elif arrays.get("page_boxes") is None:
        arrays["page_boxes"] = page_boxes_table(paged)

    def tensor(name):
        a = arrays[name]
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dtypes.get(name, torch.float32)).contiguous()
        a = np.array(a, copy=True)  # writable, contiguous
        return torch.from_numpy(a).to(device=device, dtype=dtypes.get(name, torch.float32))

    bvh = static.get("bvh")
    if bvh is not None and not isinstance(bvh, BvhTopology):
        bvh = BvhTopology(
            miss=tuple(int(v) for v in bvh.miss),
            first=tuple(int(v) for v in bvh.first),
            count=tuple(int(v) for v in bvh.count),
            order=tuple(int(v) for v in bvh.order),
        )
    kw = {k: static[k] for k in STATIC_FIELDS if k in static and k not in ("bvh", "paged")}
    for k in ("tri_mats", "tri_smooth"):
        if k in kw:
            kw[k] = tuple(v.item() if hasattr(v, "item") else v for v in kw[k])
    return ScenePack(**{n: tensor(n) for n in ARRAY_FIELDS + ("page_boxes",)}, bvh=bvh, paged=paged, **kw)
