"""Built-in scenes: Cornell box (+blocks, spheres, disc, mesh plinth), the
primitive-only "spheres" scene and the heightfield stress scene.

A jax-free copy of ``ipu_ray_lib_tpu/scene/builtin.py`` (same geometry,
same materials, same float32 arithmetic), so the port builds the very
scenes the JAX package renders. Geometry constants are the public
Cornell-box specification coordinates (ref: src/scene_utils.cpp:319-597).
"""

from __future__ import annotations

import numpy as np

from .types import (
    Camera,
    HostMesh,
    Material,
    MaterialType,
    SceneDescription,
    add_quad,
)
from .gltf import load_glb_meshes


def _quads_mesh(quads) -> HostMesh:
    m = HostMesh()
    for q in quads:
        add_quad(m, q)
    return m


def make_cornell_box_meshes():
    """The standard Cornell box: light, white (floor/ceiling/back), red, green.

    Coordinates from the public Cornell box data (as used at
    ref: src/scene_utils.cpp:373-413).
    """
    light = _quads_mesh([
        [[343, 548.7998, 227], [343, 548.7998, 332], [213, 548.7998, 332], [213, 548.7998, 227]],
    ])
    white = _quads_mesh([
        # Floor:
        [[552.8, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 559.2], [549.6, 0.0, 559.2]],
        # Ceiling:
        [[556, 548.8, 0], [556, 548.8, 559.2], [0, 548.8, 559.2], [0, 548.8, 0]],
        # Back wall:
        [[549.6, 0, 559.2], [0, 0, 559.2], [0, 548.8, 559.2], [556, 548.8, 559.2]],
    ])
    green = _quads_mesh([
        # Right wall:
        [[0, 0, 559.2], [0, 0, 0], [0, 548.8, 0], [0, 548.8, 559.2]],
    ])
    red = _quads_mesh([
        # Left wall:
        [[552.8, 0, 0], [549.6, 0, 559.2], [556, 548.8, 559.2], [556, 548.8, 0]],
    ])
    return [light, white, red, green]


def make_cornell_short_block() -> HostMesh:
    return _quads_mesh([
        [[130, 165, 65], [82, 165, 225], [240, 165, 272], [290, 165, 114]],
        [[290, 0, 114], [290, 165, 114], [240, 165, 272], [240, 0, 272]],
        [[130, 0, 65], [130, 165, 65], [290, 165, 114], [290, 0, 114]],
        [[82, 0, 225], [82, 165, 225], [130, 165, 65], [130, 0, 65]],
        [[240, 0, 272], [240, 165, 272], [82, 165, 225], [82, 0, 225]],
    ])


def make_cornell_tall_block() -> HostMesh:
    return _quads_mesh([
        [[423, 330, 247], [265, 330, 296], [314, 330, 456], [472, 330, 406]],
        [[423, 0, 247], [423, 330, 247], [472, 330, 406], [472, 0, 406]],
        [[472, 0, 406], [472, 330, 406], [314, 330, 456], [314, 0, 456]],
        [[314, 0, 456], [314, 330, 456], [265, 330, 296], [265, 0, 296]],
        [[265, 0, 296], [265, 330, 296], [423, 330, 247], [423, 0, 247]],
    ])


def _import_plinth_mesh(mesh_file: str) -> list[HostMesh]:
    """Load a GLB and apply the reference's plinth placement transform
    (ref: src/scene_utils.cpp:128-146): rotate 180deg about y, scale to a
    175-unit diagonal, translate onto the short block."""
    meshes = load_glb_meshes(mesh_file, load_normals=False)
    out = []
    for mesh in meshes:
        lo, hi = mesh.bounds()
        diag = hi - lo
        scale = np.float32(175.0 / np.sqrt(np.dot(diag, diag)))

        def tfv(v, scale=scale):
            v = v * np.array([-1, 1, -1], np.float32)  # rotate 180 about y
            v = v * scale
            return v + np.array([210, 165, 160], np.float32)

        def tfn(n):
            return n * np.array([-1, 1, -1], np.float32)

        mesh.transform(tfv, tfn)
        out.append(mesh)
    return out


def make_cornell_box_scene(mesh_file: str | None = None, box_only: bool = False) -> SceneDescription:
    """Cornell box scene with optional extra primitives and plinth mesh
    (ref: src/scene_utils.cpp:458-554)."""
    scene = SceneDescription()
    scene.meshes = make_cornell_box_meshes()
    scene.meshes.append(make_cornell_short_block())
    scene.meshes.append(make_cornell_tall_block())

    if not box_only:
        scene.spheres = np.array(
            [[450.0, 37.0, 90.0, 37.0], [350.0, 37.0, 90.0, 37.0]], np.float32
        )
        scene.discs = np.array([[1, 0, 0, 0.0002, 300.0, 250.0, 60.0]], np.float32)
        if mesh_file:
            scene.meshes.extend(_import_plinth_mesh(mesh_file))

    # Transform into camera space: camera at origin, right-handed flip of x/z.
    cam_pos = np.array([278, 273, -800], np.float32)  # Cornell spec camera
    flip = np.array([-1, 1, -1], np.float32)

    for m in scene.meshes:
        m.transform(lambda v: (v - cam_pos) * flip)

    if len(scene.spheres):
        scene.spheres[:, :3] = (scene.spheres[:, :3] - cam_pos) * flip
    if len(scene.discs):
        scene.discs[:, 3:6] = (scene.discs[:, 3:6] - cam_pos) * flip
        scene.discs[:, 0:3] = scene.discs[:, 0:3] * flip

    black = np.zeros(3, np.float32)
    red = np.array([0.66, 0.0, 0.0], np.float32)
    green = np.array([0.0, 0.48, 0.0], np.float32)
    blue = np.array([0.4, 0.4, 0.85], np.float32)
    blue_light = np.array([0.4, 0.7, 0.92], np.float32) * 2.0
    white = np.array([0.75, 0.75, 0.75], np.float32)
    grey = np.array([0.4, 0.4, 0.4], np.float32)
    light_r = np.array([0.78, 0.78, 0.78], np.float32)
    light_e = np.array(
        [
            (100.0 * 15.6 + 100.0 * 18.4) / 255.0,
            (100.0 * 8.0 + 74.5 * 15.6) / 255.0,
            (57.3 * 8.0) / 255.0,
        ],
        np.float32,
    )

    scene.materials = [
        Material(white, black, MaterialType.DIFFUSE),
        Material(red, black, MaterialType.DIFFUSE),
        Material(green, black, MaterialType.DIFFUSE),
        Material(blue, black, MaterialType.REFRACTIVE),
        Material(light_r, light_e, MaterialType.DIFFUSE),
        Material(grey, black, MaterialType.SPECULAR),
        Material(blue, blue_light, MaterialType.DIFFUSE),
        Material(blue, black, MaterialType.DIFFUSE),
    ]
    # light, white-box-parts, left-wall, right-wall, short-box, tall-box,
    # loaded meshes (hardcoded), sphere, sphere, disc:
    scene.mat_ids = [4, 0, 1, 2, 0, 5, 0, 0, 3, 7, 6]
    scene.validate()

    scene.camera = Camera(horizontal_fov=float(np.pi / 4))
    return scene


def make_stress_scene(grid: int = 512) -> SceneDescription:
    """Large-scene stress test: a displaced heightfield of
    ``2 * (grid-1)^2`` triangles under an overhead disc light. Exists to
    exercise the HBM-streamed intersector (scenes beyond the 64k-prim
    VMEM class — role of the reference's DRAM ray streaming,
    src/IpuScene.cpp:375-391); no reference counterpart scene.

    grid=512 -> 522,242 triangles."""
    n = int(grid)
    xs = np.linspace(-8.0, 8.0, n, dtype=np.float32)
    zs = np.linspace(-16.0, -2.0, n, dtype=np.float32)
    xg, zg = np.meshgrid(xs, zs, indexing="ij")
    y = (
        -2.0
        + 0.6 * np.sin(1.3 * xg) * np.cos(0.9 * zg)
        + 0.25 * np.sin(4.1 * xg + 1.7) * np.sin(3.3 * zg)
    ).astype(np.float32)
    verts = np.stack([xg, y, zg], axis=-1).reshape(-1, 3)

    idx = np.arange(n * n, dtype=np.uint32).reshape(n, n)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[:-1, 1:].ravel()
    d = idx[1:, 1:].ravel()
    tris = np.concatenate(
        [np.stack([a, b, c], axis=-1), np.stack([b, d, c], axis=-1)]
    )

    scene = SceneDescription()
    scene.meshes = [HostMesh(triangles=tris, vertices=verts)]
    scene.discs = np.array([[0, -1, 0, 0.0, 6.0, -9.0, 4.0]], np.float32)

    zero = np.zeros(3, np.float32)
    sand = np.array([0.8, 0.7, 0.55], np.float32)
    light_r = np.array([0.78, 0.78, 0.78], np.float32)
    light_e = np.array([18.0, 16.0, 14.0], np.float32)
    scene.materials = [
        Material(sand, zero, MaterialType.DIFFUSE),
        Material(light_r, light_e, MaterialType.DIFFUSE),
    ]
    scene.mat_ids = [0, 1]
    scene.camera = Camera(horizontal_fov=float(np.pi / 3))
    scene.validate()
    return scene



def make_primitive_scene() -> SceneDescription:
    """Primitive-only 'spheres' scene for NIF/HDRI demos: five spheres and
    a floor disc, no triangles (ref: src/scene_utils.cpp:557-597)."""
    scene = SceneDescription()
    scene.camera = Camera(horizontal_fov=float(np.pi / 2))

    scene.spheres = np.array(
        [
            [-1.8575, -0.98714, -3.6, 0.6],      # left
            [0.74795, -0.55, -4.3816, 1.05],     # middle
            [1.9929, -1.08666, -3.23, 0.5],      # right
            [-0.19931, -1.183, -2.75, 0.4],      # front diffuse part
            [-0.19931, -1.183, -2.75, 0.4010],   # front clear-coat part
        ],
        np.float32,
    )
    scene.discs = np.array([[0, 1, 0, 0.0, -1.6, -5.22, 3.5]], np.float32)

    zero = np.zeros(3, np.float32)
    one = np.ones(3, np.float32)
    sphere_colour = np.array([1.0, 0.89, 0.55], np.float32)
    clear_coat = np.array([0.8, 0.06, 0.391], np.float32)
    floor_colour = np.array([0.98, 0.76, 0.66], np.float32)
    glass_tint = np.array([0.75, 0.75, 0.75], np.float32)

    scene.materials = [
        Material(sphere_colour, zero, MaterialType.DIFFUSE),
        Material(one, zero, MaterialType.SPECULAR),
        Material(glass_tint, zero, MaterialType.REFRACTIVE),
        Material(clear_coat, zero, MaterialType.DIFFUSE),
        Material(one, zero, MaterialType.REFRACTIVE),
        Material(floor_colour, zero, MaterialType.DIFFUSE),
    ]
    scene.mat_ids = [0, 1, 2, 3, 4, 5]
    scene.validate()
    return scene
