"""The gpu-contract integrator on lane tensors: the plain PyTorch version.

Torch counterpart of the gpu-contract half of
``path_trace_golang_tpu/integrator.py``: the shader's iterative rayColor
(gpu.go:1300-1671) with NEE, GGX metals, tracked-glass dielectrics with
Beer-Lambert, russian roulette, and the merged sample+bounce loop with
per-lane path regeneration (:func:`pass_regen_gpu`).  Every lane draws its
uniforms on one fixed schedule per loop iteration, whatever branch it
takes (PHYSICS.md D7), which is what lets the CUDA kernel
(``ops/cuda_trace.py``) run one thread per lane and agree lane for lane.

Not ported yet (ROADMAP.md Queue A item 8): the classic per-sample loop
(``_trace_gpu``/``gpu_phase``, used for faithful fog), the cpu contract,
and ``trace_grid``/``trace``.  Each raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops import fog as fog_ops
from .ops import geometry, optics, sampling
from .ops import lights as lights_ops
from .ops.camera import camera_basis, camera_rays
from .ops.geometry import Hit, intersect_world
from .ops.rng import MASK32, LaneRng, seed_lanes
from .ops.sky import background_color
from .ops.vec import V3
from .soa import (
    MAT_DIELECTRIC,
    MAT_EMISSIVE,
    MAT_LAMBERT,
    MAT_METAL,
    MAT_MIRROR,
    OBJ_BOX,
    OBJ_SPHERE,
    ScenePack,
)

__all__ = [
    "TraceConfig",
    "trace_config_for_scene",
    "regen_enabled",
    "pass_regen_gpu",
    "fog_prepass_grid",
    "trace",
    "trace_grid",
]

_f = np.float32
_TODO_CLASSIC = (
    "the classic per-sample gpu loop (faithful fog), the cpu contract and "
    "trace()/trace_grid() are not ported yet (ROADMAP.md Queue A item 8, kernel B3)"
)


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
    regen: bool = True


def trace_config_for_scene(
    sc_pack: ScenePack, scene, max_depth: int, contract: str = "gpu", faithful_fog: bool = False
) -> TraceConfig:
    """A TraceConfig with feature flags read off the scene (integrator.py:103)."""
    has_rough_metal = False
    has_dielectric = False
    for m in scene.materials:
        if m.type == "metal":
            rough = (1.0 - min(max(m.smoothness, 0.0), 1.0)) if m.smoothness > 0 else m.rough
            if rough > 1e-4:
                has_rough_metal = True
        if m.type == "dielectric":
            has_dielectric = True
    fogm = (
        scene.fog is not None
        and scene.fog.gpu_volumetric
        and sc_pack.n_lights > 0
        and contract == "gpu"
    )
    return TraceConfig(
        max_depth=max_depth,
        contract=contract,
        enable_fog_march=bool(fogm),
        fog_in_trace=bool(faithful_fog),
        enable_nee=(contract == "gpu"),
        has_rough_metal=has_rough_metal,
        has_dielectric=has_dielectric,
        regen=contract == "gpu" and not (bool(fogm) and bool(faithful_fog)),
    )


def regen_enabled(cfg: TraceConfig) -> bool:
    """Whether the merged sample+bounce loop drives gpu-contract passes."""
    return cfg.regen and cfg.contract == "gpu" and not (cfg.enable_fog_march and cfg.fog_in_trace)


# ---------------------------------------------------------------------------
# Fog prepass
# ---------------------------------------------------------------------------


def _fog_prepass(orig: V3, dirv: V3, state, pack: ScenePack):
    """Single-scatter march along the primary ray (gpu.go:1311-1341):
    24 fixed steps to min(firstHit, 40).  Returns (radiance V3, state)."""
    fog_block = pack.host("fog")
    hit = intersect_world(orig, dirv, pack, 0.001)
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
        ls = fog_ops.estimate_volume_light(pos, dirv, pack, rng)
        w = sigma_s * tr * step
        dl = V3(fc[0] * ls.x * w, fc[1] * ls.y * w, fc[2] * ls.z * w)
        ok = (sigma_t > 0) & (sigma_s > 0) & (step > 0)
        rad = rad + V3.where(ok, dl, V3.zeros_like(w))
    return rad, rng.state


def fog_prepass_grid(orig: V3, dirv: V3, state, pack: ScenePack):
    """The volumetric march, gated on the fog block's gpu_volumetric flag
    like the shader (gpu.go:1311).  Returns (radiance V3, state)."""
    rad, state = _fog_prepass(orig, dirv, state, pack)
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
    the paged mesh walk (work pruning only, the same radiance).

    Returns (new_dir, attenuation, radiance, scattered_ok, enter_glass,
    exit_glass, travel, absorption, abs_scale, tint)."""
    zero3 = V3.zeros_like(dirv.x)
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
        direct = lights_ops.estimate_direct_light(p, n, hit.albedo, pack, rng, skip=nee_skip)
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
        rhit = intersect_world(refl_orig, mirror_dir, pack, 0.001, lite=True, skip=spec_skip)
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


# ---------------------------------------------------------------------------
# Merged sample + bounce loop with path regeneration
# ---------------------------------------------------------------------------


def pass_regen_gpu(
    pack: ScenePack,
    px,
    py,
    state0,
    *,
    cfg: TraceConfig,
    width: int,
    height: int,
    n_strata: int,
    samples: int,
    has_aperture: bool,
    frame_seed=None,
    n_passes: int = 1,
    col_init: V3 | None = None,
):
    """GPU-contract progressive pass(es) with per-lane path regeneration
    (integrator.py:523-744).

    One loop merges the stratified-sample loop (gpu.go:1683-1730) and the
    bounce loop: the moment a lane's path terminates it draws its next
    stratified sample's camera ray.  ``n_passes > 1`` runs a window of
    passes, reseeding each lane to ``seed_lanes(px, py, frame_seed + p)``
    at every pass boundary (D1).  Every iteration draws, per lane: jx, jy,
    three lens uniforms when the scene has an aperture, the shade draws (2
    Lambert, 2 per light, 2 GGX with rough metal, 1 Fresnel with glass)
    and one for russian roulette.
    Returns (col V3 = sum over all samples, state, segments int64 tensor).
    """
    pxf = px.to(torch.float32)
    zero3 = V3.zeros_like(pxf)
    col = col_init if col_init is not None else zero3
    fog_block = pack.host("fog")
    sky_fog = fog_block[0] > 0 and fog_block[2] > _f(0.5)
    basis = camera_basis(pack.cam, width, height)

    inv_w = _f(1.0) / _f(width - 1 if width > 1 else 1)
    inv_h = _f(1.0) / _f(height - 1 if height > 1 else 1)
    fy = _f(height - 1) - py.to(torch.float32)
    inv_strata = _f(1.0 / n_strata)
    total_samples = samples * n_passes

    s = torch.zeros_like(px, dtype=torch.int64)
    d = torch.zeros_like(s)
    alive = torch.zeros_like(s, dtype=torch.bool)
    orig = V3.zeros_like(pxf)
    dirv = V3.zeros_like(pxf)
    throughput = V3.full_like(pxf, 1.0)
    st = state0
    glass_obj = torch.full_like(s, -1)
    glass_dist = torch.zeros_like(pxf)
    segments = torch.zeros((), dtype=torch.int64, device=px.device)

    while bool(((alive.to(torch.int64) + (total_samples - s)) > 0).any()):
        # ---- regenerate: dead lanes with samples left start the next one
        regen = ~alive & (s < total_samples)
        if n_passes > 1:
            pass_idx = torch.div(s, samples, rounding_mode="floor")
            stratum = s - pass_idx * samples
            boundary = regen & (s > 0) & (stratum == 0)
            reseed = seed_lanes(px, py, (int(frame_seed) + pass_idx) & MASK32)
            st = torch.where(boundary, reseed, st)
        else:
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
        cam_o, cam_d = camera_rays(
            u, v, pack.cam, width, height, rng, has_aperture, pack.lens_disk, basis=basis
        )
        orig = V3.where(regen, cam_o, orig)
        dirv = V3.where(regen, cam_d, dirv)
        throughput = V3.where(regen, V3.full_like(pxf, 1.0), throughput)
        d = torch.where(regen, 0, d)
        glass_obj = torch.where(regen, -1, glass_obj)
        glass_dist = torch.where(regen, 0.0, glass_dist)
        s = torch.where(regen, s + 1, s)
        alive = alive | regen

        # ---- one bounce
        segments = segments + alive.sum()
        hit = intersect_world(
            orig, dirv, pack, 0.001, exclude_obj=glass_obj if cfg.has_dielectric else None,
            skip=~alive,
        )
        bg = background_color(dirv.normalize(), pack.sky)
        if sky_fog:
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
            tint_mul = V3.where(tint.any_positive(), tint, V3.full_like(pxf, 1.0))
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

        # ---- russian roulette on per-lane remaining depth (gpu.go:1648-1660)
        remaining = cfg.max_depth - d
        u_rr = rng.next()
        max_comp = attenuation.max_comp()
        rr_active = remaining <= cfg.rr_threshold
        rr_prob = torch.clamp_max(max_comp, 0.95)
        rr_kill = rr_active & ((max_comp < 1e-6) | (u_rr > rr_prob))
        rr_scale = torch.where(rr_active & ~rr_kill, 1.0 / torch.clamp_min(rr_prob, 1e-6), 1.0)
        attenuation = attenuation * rr_scale

        d = torch.where(alive, d + 1, d)
        alive = alive & scattered_ok & ~rr_kill & (d < cfg.max_depth)
        throughput = V3.where(alive, throughput * attenuation, throughput)
        orig = V3.where(alive, hit.p + hit.normal * 0.001, orig)
        dirv = V3.where(alive, new_dir, dirv)
        st = rng.state

    return col, st, segments


def trace_grid(*_args, **_kwargs):
    raise NotImplementedError(_TODO_CLASSIC)


def trace(*_args, **_kwargs):
    raise NotImplementedError(_TODO_CLASSIC)
