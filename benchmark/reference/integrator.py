"""Both physics contracts' bounce loops on lane tensors, for the benchmark's reference.

A frozen copy of the port's plain versions (``integrator.py``): the gpu
contract's merged sample+bounce loop with per-lane path regeneration and
the cpu contract's classic bounce loop, each returning every lane's own
segment count.  The environment's knobs are not read: the reference always
runs the configuration that a user's render runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import fog as fog_ops
from . import geometry, optics, sampling
from . import lights as lights_ops
from .camera import camera_rays
from .geometry import BIG_T, Hit, intersect_world
from .rng import LaneRng
from .sky import background_color
from .vec import V3
from .soa import (
    MAT_DIELECTRIC,
    MAT_EMISSIVE,
    MAT_LAMBERT,
    MAT_METAL,
    MAT_MIRROR,
    OBJ_BOX,
    OBJ_PLANE,
    OBJ_SPHERE,
    ScenePack,
)

__all__ = ["TraceConfig", "trace_config_for_scene", "pass_regen_gpu", "fog_prepass_grid", "trace_cpu"]

_f = np.float32


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static trace parameters; feature flags are read off the scene."""

    max_depth: int
    contract: str = "gpu"
    enable_fog_march: bool = False  # fogGpuVolumetric && lights present
    fog_in_trace: bool = True  # False = fog marched once per pass (D6)
    enable_nee: bool = True
    has_rough_metal: bool = True
    has_dielectric: bool = True
    rr_threshold: int = 3  # gpu.go:1649
    regen: bool = True  # the merged sample+bounce loop (gpu contract)
    # the port's work pruning, on as a user's render runs it, and its profiling and timing knobs, never set
    # here: the copied loops read them
    walk_skip: bool = True
    prof_no_mesh: tuple = ()
    debug_drop: tuple = ()


def trace_config_for_scene(sc_pack: ScenePack, scene, max_depth: int, contract: str = "gpu") -> TraceConfig:
    """A TraceConfig with feature flags read off the scene (integrator.py:103),
    as a user's render runs it: the regeneration loop under the gpu contract,
    the fog marched once a pass, no profiling or timing knob."""
    has_rough_metal = False
    has_dielectric = False
    for m in scene.materials:
        if m.type == "metal":
            rough = (1.0 - min(max(m.smoothness, 0.0), 1.0)) if m.smoothness > 0 else m.rough
            if rough > 1e-4:
                has_rough_metal = True
        if m.type == "dielectric":
            has_dielectric = True
    fogm = scene.fog is not None and scene.fog.gpu_volumetric and sc_pack.n_lights > 0 and contract == "gpu"
    return TraceConfig(
        max_depth=max_depth,
        contract=contract,
        enable_fog_march=bool(fogm),
        fog_in_trace=False,
        enable_nee=(contract == "gpu"),
        has_rough_metal=has_rough_metal,
        has_dielectric=has_dielectric,
        regen=(contract == "gpu"),
    )


# ---------------------------------------------------------------------------
# Fog prepass
# ---------------------------------------------------------------------------


def _fog_prepass(orig: V3, dirv: V3, state, pack: ScenePack, prof: tuple = ()):
    """Single-scatter march along the primary ray (gpu.go:1311-1341):
    24 fixed steps to min(firstHit, 40).  ``prof``: the profiling knobs
    (``TraceConfig.prof_no_mesh``).  Returns (radiance V3, state)."""
    fog_block = pack.host("fog")
    hit = intersect_world(orig, dirv, pack, 0.001, prof=prof)
    t_max = torch.clamp_max(
        torch.where(hit.hit, hit.t, fog_ops.FOG_MARCH_TMAX), fog_ops.FOG_MARCH_TMAX
    )
    step = t_max * (1.0 / fog_ops.FOG_MARCH_STEPS)
    fc = fog_block[4:7]
    rng = LaneRng(state)
    rad = V3.zeros_like(orig.x)
    for i in range(fog_ops.FOG_MARCH_STEPS):
        t = (_f(i) + _f(0.5)) * step
        pos = orig + dirv * t
        sigma_s, _sigma_a, sigma_t = fog_ops.medium_coeffs(pos, fog_block)
        tr = torch.exp(-sigma_t * t)
        ls = fog_ops.estimate_volume_light(pos, dirv, pack, rng, prof=prof)
        w = sigma_s * tr * step
        dl = V3(fc[0] * ls.x * w, fc[1] * ls.y * w, fc[2] * ls.z * w)
        ok = (sigma_t > 0) & (sigma_s > 0) & (step > 0)
        rad = rad + V3.where(ok, dl, V3.zeros_like(w))
    return rad, rng.state


def fog_prepass_grid(orig: V3, dirv: V3, state, pack: ScenePack, prof: tuple = ()):
    """The volumetric march, gated on the fog block's gpu_volumetric flag
    like the shader (gpu.go:1311).  Returns (radiance V3, state)."""
    rad, state = _fog_prepass(orig, dirv, state, pack, prof)
    gate = 1.0 if pack.host("fog")[3] > _f(0.5) else 0.0
    return rad * gate, state


# ---------------------------------------------------------------------------
# GPU-contract surface interaction
# ---------------------------------------------------------------------------


def _shade_gpu(hit: Hit, dirv: V3, throughput: V3, radiance: V3, rng: LaneRng, pack: ScenePack, cfg: TraceConfig,
               alive=None):
    """One gpu-contract surface interaction for all lanes (gpu.go:1398-1646).

    ``alive``: bool lanes of the bounce loop; the caller discards dead
    lanes' outputs, so their shadow and specular-NEE rays enter no page of
    the paged mesh walk (work pruning only, the same radiance), unless
    ``cfg.walk_skip`` is off.

    Returns (new_dir, attenuation, radiance, scattered_ok, enter_glass,
    exit_glass, travel, absorption, abs_scale, tint)."""
    zero3 = V3.zeros_like(dirv.x)
    if not cfg.walk_skip:
        alive = None
    typ = hit.mtyp
    n = hit.normal
    p = hit.p
    view_dir = dirv.normalize()

    is_lambert = typ == MAT_LAMBERT
    is_metal = typ == MAT_METAL
    is_mirror = typ == MAT_MIRROR
    is_diel = typ == MAT_DIELECTRIC
    is_emissive = typ == MAT_EMISSIVE

    radiance = radiance + V3.where(is_emissive, throughput * hit.emit, zero3)

    # ---- Lambert: cosine bounce + NEE (gpu.go:1419-1425) ----
    lambert_dir = sampling.cosine_direction(n, rng.next(), rng.next())
    if cfg.enable_nee and pack.n_lights > 0:
        nee_skip = None
        if alive is not None:
            uses_direct = (is_lambert | is_metal) if cfg.has_rough_metal else is_lambert
            nee_skip = ~(alive & hit.hit & uses_direct)
        if "shadow" in cfg.debug_drop:
            nee_skip = torch.ones_like(is_lambert)
        direct = lights_ops.estimate_direct_light(p, n, hit.albedo, pack, rng, skip=nee_skip,
                                                  prof=cfg.prof_no_mesh)
    else:
        direct = zero3
    radiance = radiance + V3.where(is_lambert, throughput * direct, zero3)

    # ---- Metal / mirror (gpu.go:1427-1496) ----
    metal_rough = torch.where(hit.smoothness > 0, 1.0 - hit.smoothness, hit.rough)
    eff_refl = torch.where(hit.reflectivity > 0, hit.reflectivity, 1.0)
    is_rough_metal = is_metal & (metal_rough > 1e-4)

    mirror_dir = optics.reflect(view_dir, n)
    if cfg.has_rough_metal:
        ggx_dir = sampling.sample_ggx(view_dir, n, metal_rough, rng.next(), rng.next())
        metal_dir = V3.where(is_rough_metal, ggx_dir, mirror_dir)
    else:
        metal_dir = mirror_dir

    mr2 = metal_rough * metal_rough
    spec_w = torch.clamp(1.0 / (1.0 + mr2 * 2.0), 0.1, 0.9)
    diff_w = 1.0 - spec_w
    radiance = radiance + V3.where(
        is_rough_metal, throughput * direct * (diff_w * eff_refl * 0.5), zero3
    )
    atten_metal = V3.where(
        is_rough_metal,
        hit.albedo * (spec_w * eff_refl + diff_w * 0.3),
        hit.albedo * eff_refl,
    )
    metal_dot = metal_dir.dot(n)
    metal_dead = (is_metal | is_mirror) & (metal_dot <= 1e-6)

    # rough-metal "specular NEE": trace the perfect reflection, credit
    # emissive hits (gpu.go:1474-1496)
    if cfg.has_rough_metal and cfg.enable_nee:
        refl_orig = p + n * 0.001
        spec_skip = None if alive is None else ~(alive & is_rough_metal & ~metal_dead)
        if "spec" in cfg.debug_drop:
            spec_skip = torch.ones_like(is_rough_metal)
        rhit = intersect_world(refl_orig, mirror_dir, pack, 0.001, lite=True, skip=spec_skip,
                               prof=cfg.prof_no_mesh)
        dist_sq = torch.clamp_min(rhit.t * rhit.t, 1e-20)
        cos_light = torch.clamp_min(-(rhit.normal.dot(mirror_dir)), 0.0)
        direct_reflect = rhit.emit * (cos_light / dist_sq)
        ok = is_rough_metal & ~metal_dead & rhit.hit & (rhit.mtyp == MAT_EMISSIVE)
        radiance = radiance + V3.where(ok, throughput * direct_reflect * hit.albedo * 0.5, zero3)

    # ---- Dielectric (gpu.go:1498-1642) ----
    false = torch.zeros_like(is_diel)
    enter_glass = exit_glass = false
    travel = torch.zeros_like(dirv.x)
    atten_diel = V3.full_like(dirv.x, 1.0)
    diel_dir = mirror_dir
    if cfg.has_dielectric:
        ior = hit.ior
        cos_t = torch.clamp_max(-(view_dir.dot(n)), 1.0)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        entering = hit.front_face
        inv_ior = 1.0 / torch.clamp_min(ior, 1e-6)
        eta = torch.where(entering, inv_ior, ior)
        rel_ior = torch.where(entering, ior, inv_ior)
        tir = eta * sin_t > 1.0
        reflect_prob = optics.schlick(cos_t, rel_ior)
        reflect_prob = torch.where(entering, reflect_prob, torch.clamp_min(reflect_prob, 0.05))
        u_fresnel = rng.next()
        do_reflect = tir | (u_fresnel < reflect_prob)

        refr_dir = optics.refract(view_dir, n, eta)
        diel_dir = V3.where(do_reflect, optics.reflect(view_dir, n), refr_dir).normalize()

        refracting = is_diel & ~do_reflect
        enter_glass = refracting & entering
        exit_glass = refracting & ~entering

        exit_orig = p + diel_dir * 0.001
        half = hit.obj_size * 0.5
        b_ok, b_t = geometry.box_exit_t(exit_orig, diel_dir, hit.obj_pos - half, hit.obj_pos + half)
        s_ok, s_t = geometry.sphere_exit_t(exit_orig, diel_dir, hit.obj_pos, hit.obj_size.x)
        travel = torch.where(
            (hit.obj_type == OBJ_BOX) & b_ok,
            b_t,
            torch.where((hit.obj_type == OBJ_SPHERE) & s_ok, s_t, 0.0),
        )
        travel = torch.where(enter_glass, travel, 0.0)

        eff_abs = hit.absorption * hit.abs_scale
        absorb_enter = (-(eff_abs * travel)).exp()
        tint_mul = V3.where(hit.tint.any_positive(), hit.tint, V3.full_like(dirv.x, 1.0))
        enter_mul = (absorb_enter * 0.9 + 0.1) * tint_mul
        atten_diel = V3.where(enter_glass & (travel > 0), enter_mul, atten_diel)

    # ---- combine ----
    new_dir = V3.where(is_lambert, lambert_dir, V3.where(is_diel, diel_dir, metal_dir))
    attenuation = V3.where(
        is_lambert,
        hit.albedo,
        V3.where(is_diel, atten_diel, V3.where(is_metal | is_mirror, atten_metal, hit.albedo)),
    )
    scattered_ok = ~(is_emissive | metal_dead)
    return (
        new_dir, attenuation, radiance, scattered_ok, enter_glass, exit_glass,
        travel, hit.absorption, hit.abs_scale, hit.tint,
    )


def _bounce_gpu(pack: ScenePack, cfg: TraceConfig, orig: V3, dirv: V3, throughput: V3, col: V3, alive, d,
                rng: LaneRng, glass_obj, glass_dist):
    """One gpu-contract bounce of the lanes ``alive`` at path depth ``d``
    (an int, or an int lane tensor): closest hit, sky on a miss, shading,
    the glass state, russian roulette (gpu.go:1343-1660).  The body of both
    the regeneration loop and the classic loop (integrator.py:428-504,
    659-727); a path also ends where depth ``d + 1`` reaches ``max_depth``.
    Returns (orig, dirv, throughput, col, alive, glass_obj, glass_dist)."""
    fog_block = pack.host("fog")
    zero3 = V3.zeros_like(orig.x)
    hit = intersect_world(
        orig, dirv, pack, 0.001, exclude_obj=glass_obj if cfg.has_dielectric else None,
        skip=torch.ones_like(alive) if "closest" in cfg.debug_drop else (~alive if cfg.walk_skip else None),
        prof=cfg.prof_no_mesh,
    )
    bg = background_color(dirv.normalize(), pack.sky)
    if fog_block[0] > 0 and fog_block[2] > _f(0.5):  # legacy sky fog (gpu.go:1392)
        bg = fog_ops.apply_legacy_fog(bg, 50.0, fog_block)
    miss = alive & ~hit.hit
    col = col + V3.where(miss, throughput * bg, zero3)
    alive = alive & hit.hit

    live_throughput = V3.where(alive, throughput, zero3)
    (new_dir, attenuation, col, scattered_ok, enter_glass, exit_glass,
     travel, absorption, abs_scale, tint) = _shade_gpu(
        hit, dirv, live_throughput, col, rng, pack, cfg, alive=alive
    )

    if cfg.has_dielectric:
        eff_abs = absorption * abs_scale
        absorb_exit = (-(eff_abs * glass_dist)).exp()
        tint_mul = V3.where(tint.any_positive(), tint, V3.full_like(orig.x, 1.0))
        exit_mul = (absorb_exit * 0.9 + 0.1) * tint_mul
        exit_apply = alive & exit_glass & (glass_dist > 0)
        attenuation = V3.where(exit_apply, attenuation * exit_mul, attenuation)

        enter_ok = alive & enter_glass
        exit_ok = alive & exit_glass
        glass_obj = torch.where(
            enter_ok, hit.obj_idx.to(torch.int64), torch.where(exit_ok, -1, glass_obj)
        )
        glass_dist = torch.where(
            enter_ok & (travel > 0), travel, torch.where(exit_ok, 0.0, glass_dist)
        )

    rr_kill, attenuation = _russian_roulette(cfg, d, rng, attenuation)
    alive = alive & scattered_ok & ~rr_kill & (d + 1 < cfg.max_depth)
    throughput = V3.where(alive, throughput * attenuation, throughput)
    orig = V3.where(alive, hit.p + hit.normal * 0.001, orig)
    dirv = V3.where(alive, new_dir, dirv)
    return orig, dirv, throughput, col, alive, glass_obj, glass_dist


def _russian_roulette(cfg: TraceConfig, d, rng: LaneRng, attenuation: V3):
    """Russian roulette on the remaining depth (gpu.go:1648-1660,
    renderer.go:373-393); one draw.  Returns (killed, attenuation)."""
    remaining = cfg.max_depth - d
    u_rr = rng.next()
    max_comp = attenuation.max_comp()
    rr_active = remaining <= cfg.rr_threshold
    rr_prob = torch.clamp_max(max_comp, 0.95)
    rr_kill = rr_active & ((max_comp < 1e-6) | (u_rr > rr_prob))
    rr_scale = torch.where(rr_active & ~rr_kill, 1.0 / torch.clamp_min(rr_prob, 1e-6), 1.0)
    return rr_kill, attenuation * rr_scale


# ---------------------------------------------------------------------------
# Merged sample + bounce loop with path regeneration
# ---------------------------------------------------------------------------


def pass_regen_gpu(pack: ScenePack, px, py, state0, *, cfg: TraceConfig, basis, width: int, height: int,
                   n_strata: int, samples: int, has_aperture: bool, col_init: V3):
    """One gpu-contract progressive pass a lane with per-lane path
    regeneration (integrator.py:523-744): one loop merges the stratified
    sample loop (gpu.go:1683-1730) and the bounce loop, and the moment a
    lane's path terminates it draws its next stratified sample's camera ray.
    Every iteration draws, per lane: jx, jy, three lens uniforms when the
    scene has an aperture, the shade draws (2 Lambert, 2 per light, 2 GGX
    with rough metal, 1 Fresnel with glass) and one for russian roulette.
    ``basis``: the camera's :func:`~.camera.camera_basis`, one for all
    lanes or one column a lane.
    Returns (col V3 = col_init + the sum over the samples, state, int64
    segments a lane)."""
    pxf = px.to(torch.float32)
    col = col_init

    inv_w = _f(1.0) / _f(width - 1 if width > 1 else 1)
    inv_h = _f(1.0) / _f(height - 1 if height > 1 else 1)
    fy = _f(height - 1) - py.to(torch.float32)
    inv_strata = _f(1.0 / n_strata)

    s = torch.zeros_like(px, dtype=torch.int64)
    d = torch.zeros_like(s)
    alive = torch.zeros_like(s, dtype=torch.bool)
    orig = V3.zeros_like(pxf)
    dirv = V3.zeros_like(pxf)
    throughput = V3.full_like(pxf, 1.0)
    st = state0
    glass_obj = torch.full_like(s, -1)
    glass_dist = torch.zeros_like(pxf)
    segments = torch.zeros_like(s)

    while bool(((alive.to(torch.int64) + (samples - s)) > 0).any()):
        # ---- regenerate: dead lanes with samples left start the next one
        regen = ~alive & (s < samples)
        stratum = s
        rng = LaneRng(st)
        jx = rng.next()
        jy = rng.next()
        if n_strata > 1:
            su = ((stratum % n_strata).to(torch.float32) + jx) * inv_strata
            sv = (torch.div(stratum, n_strata, rounding_mode="floor").to(torch.float32) + jy) * inv_strata
        else:
            su, sv = jx, jy
        u = (pxf + su) * inv_w
        v = (fy + sv) * inv_h
        cam_o, cam_d = camera_rays(u, v, rng, has_aperture, pack.lens_disk, basis)
        orig = V3.where(regen, cam_o, orig)
        dirv = V3.where(regen, cam_d, dirv)
        throughput = V3.where(regen, V3.full_like(pxf, 1.0), throughput)
        d = torch.where(regen, 0, d)
        glass_obj = torch.where(regen, -1, glass_obj)
        glass_dist = torch.where(regen, 0.0, glass_dist)
        s = torch.where(regen, s + 1, s)
        alive = alive | regen

        # ---- one bounce
        segments = segments + alive.to(torch.int64)
        orig, dirv, throughput, col, alive, glass_obj, glass_dist = _bounce_gpu(
            pack, cfg, orig, dirv, throughput, col, alive, d, rng, glass_obj, glass_dist
        )
        d = d + 1  # only live lanes read it, and regeneration resets it
        st = rng.state

    return col, st, segments


# ---------------------------------------------------------------------------
# The classic bounce loop of the cpu contract
# ---------------------------------------------------------------------------


def _dielectric_exit_scan(orig: V3, dirv: V3, pack: ScenePack):
    """Closest dielectric backface along a refracted ray (renderer.go:316-371,
    integrator.py:752-792): candidates are the analytic objects with a
    dielectric material, hit from behind, at squared distance in (1e-8,
    1000) from the origin, with t_min 1e-4.  Returns (found, exit_p V3)."""
    best_t = torch.full_like(orig.x, BIG_T)
    obj = pack.host("obj")
    for m, t, ok in geometry._object_candidates(orig, dirv, pack, 1e-4):  # exitTMin (renderer.go:322)
        if pack.mat_types[pack.obj_mats[m]] != MAT_DIELECTRIC:
            continue
        typ = pack.obj_types[m]
        cx, cy, cz, sx, sy = obj[m, 4], obj[m, 5], obj[m, 6], obj[m, 8], obj[m, 9]
        px, py, pz = orig.x + dirv.x * t, orig.y + dirv.y * t, orig.z + dirv.z * t
        if typ == OBJ_SPHERE:
            front = (dirv.x * (px - cx) + dirv.y * (py - cy) + dirv.z * (pz - cz)) < 0
        elif typ == OBJ_PLANE:
            front = dirv.y < 0
        else:  # box: the nearest-face normal chain (objects.go:186-219)
            lx, ly, lz = px - cx, py - cy, pz - cz
            on_x = torch.abs(torch.abs(lx) - sx * _f(0.5)) < 1e-4
            on_y = torch.abs(torch.abs(ly) - sy * _f(0.5)) < 1e-4
            ndot = torch.where(
                on_x, dirv.x * torch.sign(lx), torch.where(on_y, dirv.y * torch.sign(ly), dirv.z * torch.sign(lz))
            )
            front = ndot < 0
        ex, ey, ez = px - orig.x, py - orig.y, pz - orig.z
        dist_sq = ex * ex + ey * ey + ez * ez
        ok = ok & ~front & (dist_sq > 1e-8) & (dist_sq < 1000.0)
        best_t = torch.where(ok & (t < best_t), t, best_t)
    found = best_t < BIG_T
    exit_p = orig + dirv * torch.where(found, best_t, 0.0)
    return found, exit_p


def trace_cpu(orig: V3, dirv: V3, state, pack: ScenePack, cfg: TraceConfig, active=None):
    """CPU-contract bounce loop for given rays (renderer.go:286-404,
    materials.go:74-224; integrator.py:795-935).  Nine draws per bounce:
    2 + 3 for the Lambert cosine and its rough jitter, 2 for the metal's
    cosine lobe, 1 Fresnel, 1 russian roulette.  Unlike the gpu contract:
    the scatter ray starts at the hit point itself, ``ior == 0`` means
    1.5, roughness comes from smoothness, Schlick takes the refraction
    ratio, an entering refracted ray jumps to the exit point found by the
    exit scan (Beer-Lambert over that distance), no NEE, no fog.
    Returns (radiance V3, state, int64 segments a lane)."""
    radiance = V3.zeros_like(orig.x)
    throughput = V3.full_like(orig.x, 1.0)
    alive = torch.ones_like(orig.x, dtype=torch.bool) if active is None else active
    segments = torch.zeros_like(orig.x, dtype=torch.int64)
    zero3 = V3.zeros_like(orig.x)
    d = 0
    while d < cfg.max_depth and bool(alive.any()):
        segments = segments + alive.to(torch.int64)
        rng = LaneRng(state)
        hit = intersect_world(orig, dirv, pack, 0.001, skip=~alive if cfg.walk_skip else None,
                              prof=cfg.prof_no_mesh)
        miss = alive & ~hit.hit
        radiance = radiance + V3.where(miss, throughput * background_color(dirv.normalize(), pack.sky), zero3)
        alive = alive & hit.hit

        typ = hit.mtyp
        rough = torch.where(
            (typ == MAT_METAL) & (hit.smoothness > 0),
            torch.clamp(1.0 - hit.smoothness, 0.0, 1.0),
            torch.clamp(hit.rough, 0.0, 1.0),
        )
        ior = torch.where(hit.ior == 0, 1.5, hit.ior)  # materials.go:42-45
        n = hit.normal
        p = hit.p
        view_dir = dirv.normalize()
        is_lambert = typ == MAT_LAMBERT
        is_metal = typ == MAT_METAL
        is_mirror = typ == MAT_MIRROR
        is_diel = typ == MAT_DIELECTRIC
        is_emissive = typ == MAT_EMISSIVE

        radiance = radiance + V3.where(alive & is_emissive, throughput * hit.emit, zero3)

        # Lambert: cosine lobe plus a rough jitter (materials.go:76-97)
        cos_dir = sampling.cosine_direction_onb(n, rng.next(), rng.next())
        jit_ball = sampling.unit_ball(*rng.next3())
        lam_dir = (cos_dir + jit_ball * (rough * 0.1)).normalize()
        lambert_dir = V3.where(rough > 1e-6, lam_dir, cos_dir)

        # metal: mirror blended toward a cosine lobe by rough^2 (materials.go:99-160)
        reflected = optics.reflect(view_dir, n)
        cos_around_refl = sampling.cosine_direction_onb(reflected, rng.next(), rng.next())
        alpha = rough * rough
        blended = reflected * (1.0 - alpha) + cos_around_refl * alpha
        blended = V3.where(blended.length_sq() < 1e-8, reflected, blended.normalize())
        rough_metal_dir = V3.where(blended.dot(n) <= 0, reflected, blended)
        metal_dir = V3.where(rough > 1e-6, rough_metal_dir, reflected)

        # dielectric: Schlick on the refraction ratio (materials.go:162-200)
        cos_t = torch.clamp_max(-(view_dir.dot(n)), 1.0)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        entering = hit.front_face
        ratio = torch.where(entering, 1.0 / ior, ior)
        cannot = ratio * sin_t > 1.0
        refl_prob = optics.schlick(cos_t, ratio)
        do_reflect = cannot | (refl_prob > rng.next())
        diel_dir = V3.where(do_reflect, optics.reflect(view_dir, n), optics.refract(view_dir, n, ratio))

        new_dir = V3.where(
            is_lambert, lambert_dir,
            V3.where(is_diel, diel_dir, V3.where(is_metal | is_mirror, metal_dir, lambert_dir)),
        )
        attenuation = V3.where(is_diel, V3.full_like(orig.x, 1.0), hit.albedo)

        # Beer-Lambert through the exit scan (renderer.go:316-371)
        new_orig = p
        if cfg.has_dielectric:
            found, exit_p = _dielectric_exit_scan(p, new_dir, pack)
            dist = (exit_p - p).length()
            beer = (-(hit.absorption * dist)).exp()
            apply = is_diel & entering & ~do_reflect & alive & found
            attenuation = V3.where(apply & hit.absorption.any_positive(), beer, attenuation)
            new_orig = V3.where(apply, exit_p, new_orig)

        rr_kill, attenuation = _russian_roulette(cfg, d, rng, attenuation)
        alive = alive & ~is_emissive & ~rr_kill
        throughput = V3.where(alive, throughput * attenuation, throughput)
        orig = V3.where(alive, new_orig, orig)  # no epsilon offset (renderer.go:292)
        dirv = V3.where(alive, new_dir, dirv)
        state = rng.state
        d += 1
    return radiance, state, segments
