"""Scene data model: JSON-schema-compatible dataclasses.

TPU-native re-design of the reference scene model
(``internal/scene/scene.go:9-158``).  Field names, JSON keys and default
semantics are kept bit-compatible so the five reference ``scenes/*.json``
files load unchanged.  Loader-time material defaults mirror both the CPU
converter (``internal/engine/materials.go:28-55``) and the GPU packer
(``internal/engine/gpu/gpu.go:1850-1912``); the defaults themselves are
applied at SoA-pack time (see :mod:`path_trace_golang_tpu_torch.soa`) so the
dataclasses round-trip the raw JSON exactly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = [
    "Vec3",
    "Color",
    "Camera",
    "Material",
    "Object",
    "RenderSettings",
    "Fog",
    "Sky",
    "Scene",
    "MATERIAL_TYPES",
    "OBJECT_TYPES",
]

# Material / object type enums (string-typed in JSON, like the reference).
# internal/scene/scene.go:37-43 and :73-78.
MATERIAL_TYPES = ("lambert", "metal", "dielectric", "emissive", "mirror")
# "triangle" and "mesh" are this framework's north-star extension
# (BASELINE.json): the reference supports only the first four.
OBJECT_TYPES = ("sphere", "plane", "box", "sphere_light", "triangle", "mesh")


@dataclass
class Vec3:
    """3D vector / point (internal/scene/scene.go:9-13)."""

    x: float = 0.0
    y: float = 0.0
    z: float = 0.0

    def to_json(self) -> Dict[str, float]:
        return {"x": self.x, "y": self.y, "z": self.z}

    @classmethod
    def from_json(cls, d: Optional[Dict[str, Any]]) -> "Vec3":
        d = d or {}
        return cls(float(d.get("x", 0.0)), float(d.get("y", 0.0)), float(d.get("z", 0.0)))

    def as_tuple(self):
        return (self.x, self.y, self.z)


@dataclass
class Color:
    """Linear-space RGB color (internal/scene/scene.go:16-20)."""

    r: float = 0.0
    g: float = 0.0
    b: float = 0.0

    def to_json(self) -> Dict[str, float]:
        return {"r": self.r, "g": self.g, "b": self.b}

    @classmethod
    def from_json(cls, d: Optional[Dict[str, Any]]) -> "Color":
        d = d or {}
        return cls(float(d.get("r", 0.0)), float(d.get("g", 0.0)), float(d.get("b", 0.0)))

    def as_tuple(self):
        return (self.r, self.g, self.b)


@dataclass
class Camera:
    """Look-at thin-lens camera (internal/scene/scene.go:23-32).

    ``focus_dist == 0`` means "use |position - target|"
    (internal/engine/camera.go:38-41); ``aspect_ratio == 0`` means
    "use width/height" (camera.go:20-23).  Those fallbacks are applied
    by the renderer, not stored here.
    """

    position: Vec3 = field(default_factory=Vec3)
    target: Vec3 = field(default_factory=Vec3)
    up: Vec3 = field(default_factory=lambda: Vec3(0.0, 1.0, 0.0))
    fov: float = 60.0
    aperture: float = 0.0
    focus_dist: float = 0.0
    aspect_ratio: float = 0.0
    # Extension (not in the reference): defocus sampling model.  "ball"
    # keeps the reference's unit-*ball* bokeh quirk (camera.go:62,
    # gpu.go:1113 — PHYSICS.md Q4); "disk" samples a proper thin-lens
    # concentric disk.  Serialized only when non-default so reference
    # scene files round-trip byte-identically.
    lens: str = "ball"

    def to_json(self) -> Dict[str, Any]:
        d = {
            "position": self.position.to_json(),
            "target": self.target.to_json(),
            "up": self.up.to_json(),
            "fov": self.fov,
            "aperture": self.aperture,
            "focus_dist": self.focus_dist,
            "aspect_ratio": self.aspect_ratio,
        }
        if self.lens != "ball":
            d["lens"] = self.lens
        return d

    @classmethod
    def from_json(cls, d: Optional[Dict[str, Any]]) -> "Camera":
        d = d or {}
        return cls(
            position=Vec3.from_json(d.get("position")),
            target=Vec3.from_json(d.get("target")),
            up=Vec3.from_json(d.get("up")),
            fov=float(d.get("fov", 0.0)),
            aperture=float(d.get("aperture", 0.0)),
            focus_dist=float(d.get("focus_dist", 0.0)),
            aspect_ratio=float(d.get("aspect_ratio", 0.0)),
            lens=str(d.get("lens", "ball")),
        )


@dataclass
class Material:
    """Surface material (internal/scene/scene.go:46-68).

    Notable reference defaults (applied downstream at pack time):

    * metal: ``rough = 1 - smoothness`` when ``smoothness > 0``
      (materials.go:36-39); packer default ``smoothness = 1 - rough`` and
      ``reflectivity = 1`` when unset (gpu.go:1854-1883).
    * dielectric: ``ior -> 1.5`` when 0 (materials.go:42-45),
      ``absorption_scale -> 0.01`` (gpu.go:1894-1899),
      ``tint -> (1,1,1)`` when all-zero (gpu.go:1901-1912).
    * emissive: radiance = ``emit * power`` (materials.go:30, gpu.go:1886-1888).
    """

    id: str = ""
    type: str = "lambert"
    albedo: Color = field(default_factory=Color)
    rough: float = 0.0
    ior: float = 0.0
    emit: Color = field(default_factory=Color)
    power: float = 0.0
    absorption: Color = field(default_factory=Color)
    smoothness: float = 0.0
    reflectivity: float = 0.0
    tint: Color = field(default_factory=Color)
    absorption_scale: float = 0.0

    def to_json(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "type": self.type,
            "albedo": self.albedo.to_json(),
            "rough": self.rough,
            "ior": self.ior,
            "emit": self.emit.to_json(),
            "power": self.power,
            "absorption": self.absorption.to_json(),
            "smoothness": self.smoothness,
            "reflectivity": self.reflectivity,
            "tint": self.tint.to_json(),
            "absorption_scale": self.absorption_scale,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Material":
        return cls(
            id=str(d.get("id", "")),
            type=str(d.get("type", "lambert")),
            albedo=Color.from_json(d.get("albedo")),
            rough=float(d.get("rough", 0.0)),
            ior=float(d.get("ior", 0.0)),
            emit=Color.from_json(d.get("emit")),
            power=float(d.get("power", 0.0)),
            absorption=Color.from_json(d.get("absorption")),
            smoothness=float(d.get("smoothness", 0.0)),
            reflectivity=float(d.get("reflectivity", 0.0)),
            tint=Color.from_json(d.get("tint")),
            absorption_scale=float(d.get("absorption_scale", 0.0)),
        )


@dataclass
class Object:
    """Scene entity (internal/scene/scene.go:81-89).

    ``size.x`` is the radius for spheres; for boxes ``size`` is the full
    extent (box spans ``position ± size/2``, objects.go:258-265); planes
    ignore size and use a fixed +Y normal (objects.go:251-257).
    ``sphere_light`` is a sphere whose material should be emissive
    (objects.go:244-250).

    Extensions (not in the reference; BASELINE.json north star):

    * ``type="triangle"`` — a single triangle; ``vertices`` holds its
      three corners (``position``/``size`` ignored).
    * ``type="mesh"`` — an indexed triangle mesh: ``mesh`` is
      ``{"vertices": [[x,y,z], ...], "faces": [[i,j,k], ...]}``;
      ``position`` translates and nonzero ``size`` components scale the
      mesh.  Meshes are intersected through a BVH (ops/bvh.py).
      Optional ``"smooth": true`` shades with area-weighted vertex
      normals interpolated by the hit barycentrics instead of flat
      face normals.
    """

    id: str = ""
    type: str = "sphere"
    position: Vec3 = field(default_factory=Vec3)
    size: Vec3 = field(default_factory=Vec3)
    material_id: str = ""
    vertices: Optional[List[Vec3]] = None
    mesh: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        d = {
            "id": self.id,
            "type": self.type,
            "position": self.position.to_json(),
            "size": self.size.to_json(),
            "material_id": self.material_id,
        }
        if self.vertices is not None:
            d["vertices"] = [v.to_json() for v in self.vertices]
        if self.mesh is not None:
            d["mesh"] = self.mesh
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Object":
        verts = d.get("vertices")
        return cls(
            id=str(d.get("id", "")),
            type=str(d.get("type", "sphere")),
            position=Vec3.from_json(d.get("position")),
            size=Vec3.from_json(d.get("size")),
            material_id=str(d.get("material_id", "")),
            vertices=[Vec3.from_json(v) for v in verts] if verts else None,
            mesh=d.get("mesh"),
        )


@dataclass
class RenderSettings:
    """Quality/performance parameters (internal/scene/scene.go:92-97)."""

    width: int = 0
    height: int = 0
    samples_per_px: int = 0
    max_depth: int = 0

    def to_json(self) -> Dict[str, int]:
        return {
            "width": self.width,
            "height": self.height,
            "samples_per_px": self.samples_per_px,
            "max_depth": self.max_depth,
        }

    @classmethod
    def from_json(cls, d: Optional[Dict[str, Any]]) -> "RenderSettings":
        d = d or {}
        return cls(
            width=int(d.get("width", 0)),
            height=int(d.get("height", 0)),
            samples_per_px=int(d.get("samples_per_px", 0)),
            max_depth=int(d.get("max_depth", 0)),
        )

    def is_zero(self) -> bool:
        """True when all-zero, meaning 'fall back to mode preset'
        (internal/ui/app.go:61-70 behavior)."""
        return (
            self.width == 0
            and self.height == 0
            and self.samples_per_px == 0
            and self.max_depth == 0
        )


@dataclass
class Fog:
    """Participating medium (internal/scene/scene.go:101-135).

    ``sigma_s``/``sigma_a`` are the physical coefficients; when both are
    zero they are derived from ``density``/``scatter``
    (gpu.go:2044-2063, shader mediumCoeffs gpu.go:1174-1203).
    """

    density: float = 0.0
    color: Color = field(default_factory=Color)
    scatter: float = 0.0
    sigma_s: float = 0.0
    sigma_a: float = 0.0
    g: float = 0.0
    hetero_strength: float = 0.0
    noise_scale: float = 0.0
    noise_octaves: int = 0
    affect_sky: bool = False
    gpu_volumetric: bool = False

    def to_json(self) -> Dict[str, Any]:
        return {
            "density": self.density,
            "color": self.color.to_json(),
            "scatter": self.scatter,
            "sigma_s": self.sigma_s,
            "sigma_a": self.sigma_a,
            "g": self.g,
            "hetero_strength": self.hetero_strength,
            "noise_scale": self.noise_scale,
            "noise_octaves": self.noise_octaves,
            "affect_sky": self.affect_sky,
            "gpu_volumetric": self.gpu_volumetric,
        }

    @classmethod
    def from_json(cls, d: Optional[Dict[str, Any]]) -> Optional["Fog"]:
        if d is None:
            return None
        return cls(
            density=float(d.get("density", 0.0)),
            color=Color.from_json(d.get("color")),
            scatter=float(d.get("scatter", 0.0)),
            sigma_s=float(d.get("sigma_s", 0.0)),
            sigma_a=float(d.get("sigma_a", 0.0)),
            g=float(d.get("g", 0.0)),
            hetero_strength=float(d.get("hetero_strength", 0.0)),
            noise_scale=float(d.get("noise_scale", 0.0)),
            noise_octaves=int(d.get("noise_octaves", 0)),
            affect_sky=bool(d.get("affect_sky", False)),
            gpu_volumetric=bool(d.get("gpu_volumetric", False)),
        )


@dataclass
class Sky:
    """Sky / environment (internal/scene/scene.go:138-143).

    ``type`` is "solid" or "gradient"; anything else falls back to the
    deprecated flat ``Scene.background`` color (shader backgroundColor,
    gpu.go:1073-1088).
    """

    type: str = "solid"
    color: Color = field(default_factory=Color)
    horizon: Color = field(default_factory=Color)
    zenith: Color = field(default_factory=Color)

    def to_json(self) -> Dict[str, Any]:
        return {
            "type": self.type,
            "color": self.color.to_json(),
            "horizon": self.horizon.to_json(),
            "zenith": self.zenith.to_json(),
        }

    @classmethod
    def from_json(cls, d: Optional[Dict[str, Any]]) -> Optional["Sky"]:
        if d is None:
            return None
        return cls(
            type=str(d.get("type", "solid")),
            color=Color.from_json(d.get("color")),
            horizon=Color.from_json(d.get("horizon")),
            zenith=Color.from_json(d.get("zenith")),
        )


@dataclass
class Scene:
    """Everything needed to render an image (internal/scene/scene.go:146-158)."""

    name: str = ""
    camera: Camera = field(default_factory=Camera)
    objects: List[Object] = field(default_factory=list)
    materials: List[Material] = field(default_factory=list)
    settings: RenderSettings = field(default_factory=RenderSettings)
    background: Color = field(default_factory=Color)
    sky: Optional[Sky] = None
    fog: Optional[Fog] = None

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "camera": self.camera.to_json(),
            "objects": [o.to_json() for o in self.objects],
            "materials": [m.to_json() for m in self.materials],
            "settings": self.settings.to_json(),
            "background": self.background.to_json(),
        }
        # sky is a nullable pointer in the reference; fog uses omitempty
        # (scene.go:154-157).
        d["sky"] = self.sky.to_json() if self.sky is not None else None
        if self.fog is not None:
            d["fog"] = self.fog.to_json()
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Scene":
        return cls(
            name=str(d.get("name", "")),
            camera=Camera.from_json(d.get("camera")),
            objects=[Object.from_json(o) for o in d.get("objects", []) or []],
            materials=[Material.from_json(m) for m in d.get("materials", []) or []],
            settings=RenderSettings.from_json(d.get("settings")),
            background=Color.from_json(d.get("background")),
            sky=Sky.from_json(d.get("sky")),
            fog=Fog.from_json(d.get("fog")),
        )

    def material_index(self) -> Dict[str, int]:
        """material id -> position, mirroring gpu.go:1920-1923.

        Like the Go map, later duplicates win; unknown material ids
        resolve to index 0 (gpu.go:1944-1951).
        """
        return {m.id: i for i, m in enumerate(self.materials)}

    def copy(self) -> "Scene":
        """Deep copy (for the interactive editor's mutate-and-re-render loop)."""
        return dataclasses.replace(
            self,
            camera=dataclasses.replace(
                self.camera,
                position=dataclasses.replace(self.camera.position),
                target=dataclasses.replace(self.camera.target),
                up=dataclasses.replace(self.camera.up),
            ),
            objects=[
                dataclasses.replace(
                    o,
                    position=dataclasses.replace(o.position),
                    size=dataclasses.replace(o.size),
                )
                for o in self.objects
            ],
            materials=[
                dataclasses.replace(
                    m,
                    albedo=dataclasses.replace(m.albedo),
                    emit=dataclasses.replace(m.emit),
                    absorption=dataclasses.replace(m.absorption),
                    tint=dataclasses.replace(m.tint),
                )
                for m in self.materials
            ],
            settings=dataclasses.replace(self.settings),
            background=dataclasses.replace(self.background),
            sky=dataclasses.replace(self.sky) if self.sky is not None else None,
            fog=dataclasses.replace(self.fog) if self.fog is not None else None,
        )
