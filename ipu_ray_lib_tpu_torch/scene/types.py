"""Host-side scene description types (numpy).

Equivalent in role to the reference's ``SceneDescription``/``Camera``/
``Material``/``HostTriangleMesh`` (ref: include/scene_utils.hpp:15-42,
include/Material.hpp:8-33, include/Mesh.hpp) — redesigned as plain numpy
containers: device transport is a pytree of arrays, so there is no
serialiser layer and no templated storage.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class MaterialType(enum.IntEnum):
    DIFFUSE = 0
    SPECULAR = 1
    REFRACTIVE = 2


@dataclass
class Material:
    """Minimal material: albedo, ior, emission, type (ref: include/Material.hpp)."""

    albedo: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    type: MaterialType = MaterialType.DIFFUSE
    ior: float = 1.52

    def __post_init__(self):
        self.albedo = np.asarray(self.albedo, np.float32)
        self.emission = np.asarray(self.emission, np.float32)

    @property
    def emissive(self) -> bool:
        return bool(np.any(self.emission != 0.0))


@dataclass
class Camera:
    horizontal_fov: float = float(np.pi / 4)
    # Row-major 4x4 homogeneous matrix (world -> pre-transform), as imported.
    matrix: Optional[np.ndarray] = None


@dataclass
class CropWindow:
    """Render window: width x height at column/row offset (ref: Scene.hpp:20-25)."""

    w: int
    h: int
    c: int = 0
    r: int = 0


@dataclass
class PathTraceSettings:
    samples_per_pixel: int = 256
    max_path_length: int = 10
    roulette_start_depth: int = 3
    rng_seed: int = 1442


@dataclass
class HostMesh:
    """A triangle mesh: uint32 triangle vertex-index triples + float32 vertices."""

    triangles: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.uint32))
    vertices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))

    def __post_init__(self):
        self.triangles = np.asarray(self.triangles, np.uint32).reshape(-1, 3)
        self.vertices = np.asarray(self.vertices, np.float32).reshape(-1, 3)
        self.normals = np.asarray(self.normals, np.float32).reshape(-1, 3)

    @property
    def has_normals(self) -> bool:
        return self.normals.shape[0] == self.vertices.shape[0] and len(self.vertices)

    def bounds(self):
        if len(self.vertices) == 0:
            inf = np.float32(np.inf)
            return np.full(3, inf), np.full(3, -inf)
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def triangle_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-triangle AABBs: ([T,3] min, [T,3] max).

        Min/max chains over the three corner gathers — same values as
        reducing a materialised [T, 3, 3] but without the 36-byte/tri
        temporary and numpy's strided axis-1 reduction (2-3x on
        multi-million-triangle imports).
        """
        v0 = self.vertices[self.triangles[:, 0]]
        v1 = self.vertices[self.triangles[:, 1]]
        v2 = self.vertices[self.triangles[:, 2]]
        return (np.minimum(np.minimum(v0, v1), v2),
                np.maximum(np.maximum(v0, v1), v2))

    def transform(self, tf_verts, tf_normals=None) -> None:
        """Apply vectorised transforms to vertices (and normals if present)."""
        self.vertices = np.asarray(tf_verts(self.vertices), np.float32)
        if tf_normals is not None and len(self.normals):
            self.normals = np.asarray(tf_normals(self.normals), np.float32)


def add_quad(mesh: HostMesh, verts) -> None:
    """Append a quad as two triangles (ref: src/scene_utils.cpp:30-45)."""
    verts = np.asarray(verts, np.float32)
    if verts.shape != (4, 3):
        raise ValueError("Quad must have 4 vertices.")
    base = len(mesh.vertices)
    mesh.vertices = np.concatenate([mesh.vertices, verts])
    tris = np.array([[0, 1, 2], [2, 3, 0]], np.uint32) + np.uint32(base)
    mesh.triangles = np.concatenate([mesh.triangles, tris])


@dataclass
class SceneDescription:
    """High-level scene: meshes + analytic prims + materials + camera.

    Geometry ordering defines geomIDs: meshes first, then spheres, then
    discs — identical to the reference's registration order
    (ref: src/app_utils.cpp:321-339), which material assignment relies on.
    """

    meshes: List[HostMesh] = field(default_factory=list)
    spheres: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))
    # Disc rows: nx, ny, nz, cx, cy, cz, r
    discs: np.ndarray = field(default_factory=lambda: np.zeros((0, 7), np.float32))
    materials: List[Material] = field(default_factory=list)
    mat_ids: List[int] = field(default_factory=list)
    camera: Camera = field(default_factory=Camera)
    path_trace: Optional[PathTraceSettings] = None

    def __post_init__(self):
        self.spheres = np.asarray(self.spheres, np.float32).reshape(-1, 4)
        self.discs = np.asarray(self.discs, np.float32).reshape(-1, 7)

    @property
    def num_geoms(self) -> int:
        return len(self.meshes) + len(self.spheres) + len(self.discs)

    def validate(self) -> None:
        if len(self.mat_ids) < self.num_geoms:
            raise ValueError("All primitives must be assigned a material.")
