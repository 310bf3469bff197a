"""The grid512 configuration's scene as the system receives it: the
port's own large-scene generator, ``make_stress_scene(grid)`` (a
displaced heightfield of 2 (grid-1)^2 triangles under an emissive
disc), with each triangle's last two corners exchanged.

The generator winds its triangles so that every face normal points down,
away from the disc. The renderer samples a diffuse bounce about the face
normal as it is wound, so the generator's ground is never lit: its
pixels read 0 whatever the triangle walk answers, and no comparison of
pixels could see that walk. A mesh a user imports has its faces wound
outward, here up, towards the light; that is the mesh this cell renders.
The vertices, disc, materials and camera are the generator's."""

from __future__ import annotations

from ipu_ray_lib_tpu_torch.scene.builtin import make_stress_scene


def make(grid: int):
    scene = make_stress_scene(grid)
    for m in scene.meshes:
        m.triangles = m.triangles[:, [0, 2, 1]].copy()
    return scene
