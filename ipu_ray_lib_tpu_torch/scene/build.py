"""Scene compilation: SceneDescription -> tensors for the megakernel.

Port of ``ipu_ray_lib_tpu/scene/build.py`` ``build_scene`` for the
megakernel path, at any scene size. The host work (vertex rebasing, the
geometry registry, the scene BVH whose leaf order sorts tri-only scenes
and every scene above the VMEM ceiling, the blocked tables and the
sphere/disc tables) is the JAX package's, in numpy; the result is a
:class:`TorchScene` of tensors on the requested device and the same
static :class:`SceneParams`.

Four intersectors, as in the JAX package: ``"pallas"`` (the VMEM-mode
walk, kernel K1) and ``"pallas-hbm"`` (the HBM-mode walk, K3: super-group,
super and block culls, f32 winner barycentrics in the payload), which the
megakernel runs; and ``"bvh"`` (the threaded-BVH walk, K7) and
``"dense"`` (the brute-force triangle test, K8), which the XLA-loop
integrator, the per-sample wavefront and the shadow trace's glue route
run. ``"auto"`` resolves as the JAX package does on its accelerator, to
one of the first two; the last two are reached by name only. Their
leaves (the threaded BVH, the geometry ``hit_normal`` gathers and the
dense tables) are uploaded for them alone.

GeomID order matches the reference: meshes, then spheres, then discs.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..bvh.builder import INVALID_GEOM_ID, build_bvh
from ..ops.dense import build_dense_tables, dense_leaves
from ..ops.ids import GEOM_DISC, GEOM_MESH, GEOM_SPHERE, INTERSECTORS
from ..ops.tables import (HBM_SPLIT_MIN_TRIS, SB, TB, build_blocked_tables,
                          padded_boxes)
from ..runtime.device import cuda_device
from .types import CropWindow, SceneDescription

# The JAX package's VMEM ceiling: "auto" picks the HBM walk for scenes
# with more primitives, and mixed scenes with more triangles take the
# scene BVH's leaf order (ipu_ray_lib_tpu/scene/build.py:246, :304-316):
VMEM_TABLE_MAX_TRIS = 65536
# The JAX package's rule for the dense tables: built up to this many
# triangles, above it only when ``intersector="dense"`` is asked for
# (ipu_ray_lib_tpu/scene/build.py:264-276).
DENSE_TABLE_MAX_TRIS = 65536

# Render settings: the reference's defaults, which its benchmark uses.
ANTI_ALIAS_SCALE = 0.25
MAX_PATH_LENGTH = 10
ROULETTE_START_DEPTH = 3
RNG_SEED = 1442


@dataclass(frozen=True)
class SceneParams:
    """Static scene/render metadata (same fields as the JAX package's)."""

    num_bvh_nodes: int
    bvh_max_depth: int
    num_geoms: int
    num_meshes: int
    image_width: int
    image_height: int
    fov_radians: float
    anti_alias_scale: float
    max_path_length: int
    roulette_start_depth: int
    samples_per_pixel: int
    rng_seed: int
    window_w: int
    window_h: int
    window_c: int
    window_r: int
    path_trace: bool
    intersector: str = "pallas"  # one of INTERSECTORS


@dataclass
class TorchScene:
    """Device tensors of one scene, as the megakernel reads them."""

    p: torch.Tensor           # [nb*128, 16] f32 triangle rows
    nrm: torch.Tensor         # [8, nb*384] f32 normal basis + material
    baabb: torch.Tensor       # [nb, 8] f32 block AABBs
    saabb: torch.Tensor       # [nb/8, 8] f32 super AABBs
    sgaabb: torch.Tensor      # [ceil(nb/64), 8] f32 super-group AABBs
    ap: torch.Tensor          # [P, 16] f32 sphere/disc geometry rows
    apay: torch.Tensor        # [16, P] f32 sphere/disc payload columns
    # What the shadow-trace epilogue reads (ops/shadow.py): geometry and
    # primitive ids of each triangle row (padding -1), of each sphere and
    # disc row, and the materials.
    tri_geom: torch.Tensor    # [nb*128] i32
    tri_prim: torch.Tensor    # [nb*128] i32
    sphere_geom: torch.Tensor  # [S] i32 (S >= 1: a padding row if none)
    disc_geom: torch.Tensor   # [D] i32 (D >= 1)
    mat_id: torch.Tensor      # [G] i32 material of each geometry
    mat_albedo: torch.Tensor  # [M, 3] f32
    # The rest of the materials, which the glue route's sphere and disc
    # overrides read (ops/traversal.py pallas_path_intersect):
    mat_type: torch.Tensor    # [M] i32
    mat_ior: torch.Tensor     # [M] f32
    mat_emission: torch.Tensor  # [M, 3] f32
    mat_emissive: torch.Tensor  # [M] i32
    # Whether ``nrm`` holds bf16 values (HBM mode above HBM_SPLIT_MIN_TRIS
    # padded rows, or ``payload_split=True``): the HBM-mode closest-hit
    # kernel then rounds the winner's barycentrics to bf16 too.
    payload_split: bool = False
    # The blocks' padded boxes, lane coefficients and kinds, from ``p``
    # (ops/tables.py padded_boxes): the per-lane cull of K4 and K5, which
    # walk VMEM-mode scenes. None in HBM mode (K3 and K6 do not read it).
    pbox: torch.Tensor | None = None  # [nb, 8] f32
    # The scene BVH's root box: its min corner and its f16 extent widened
    # to f32, [2, 3]; the per-sample path tracer's ray sort reads it
    # (render/path.py). None for tables built without the scene BVH.
    root_box: torch.Tensor | None = None
    # The leaves of the "bvh" and "dense" intersectors (None unless the
    # scene was built for one of them): the threaded BVH, one node of 8
    # words per row (lo.xyz f32, the f16 extents x|y and z|0, meta, geom,
    # miss; ops/bvh.py); the geometry the leaf tests and ``hit_normal``
    # gather (the JAX package's SceneArrays leaves of those names); the
    # dense tables, one triangle per row of 16 f32 (ops/dense.py
    # DENSE_COLS) with the geometry and primitive id of each row, None
    # above DENSE_TABLE_MAX_TRIS unless "dense" was asked for.
    bvh_nodes: torch.Tensor | None = None     # [N, 8] i32
    verts: torch.Tensor | None = None         # [V, 3] f32
    normals: torch.Tensor | None = None       # [V, 3] f32
    tri_v: torch.Tensor | None = None         # [T, 3] i32
    mesh_first_tri: torch.Tensor | None = None  # [M] i32
    mesh_has_normals: torch.Tensor | None = None  # [M] i32
    geom_type: torch.Tensor | None = None     # [G] i32
    geom_index: torch.Tensor | None = None    # [G] i32
    spheres: torch.Tensor | None = None       # [S, 4] f32
    discs: torch.Tensor | None = None         # [D, 7] f32
    dense_rows: torch.Tensor | None = None    # [Tp, 16] f32
    dense_geom: torch.Tensor | None = None    # [Tp] i32
    dense_prim: torch.Tensor | None = None    # [Tp] i32

    @property
    def device(self) -> torch.device:
        return self.p.device

    @property
    def num_blocks(self) -> int:
        return self.baabb.shape[0]

    @property
    def n_ap(self) -> int:
        return self.ap.shape[0]

    @property
    def n_spheres(self) -> int:
        """Sphere rows: ``ap`` rows [0, S); the disc rows follow."""
        return self.sphere_geom.shape[0]

    @property
    def n_discs(self) -> int:
        return self.disc_geom.shape[0]

    def to(self, device) -> "TorchScene":
        return replace(self, **{f.name: getattr(self, f.name).to(device)
                                for f in fields(self)
                                if isinstance(getattr(self, f.name),
                                              torch.Tensor)})


def analytic_tables(spheres, discs, sphere_geom, disc_geom, mat_id,
                    mat_albedo, mat_ior, mat_type, mat_emissive,
                    mat_emission):
    """Pack spheres + discs into the kernel's two small tables (numpy f32;
    port of ``_analytic_tables``, megakernel.py:2561): ap [P, 16] rows
    (kind, centre, disc normal, r^2, disc plane offset) and apay [16, P]
    columns (albedo, ior, type+4*emissive, emission, centre, disc normal,
    kind). Padding rows have kind 0 and never hit."""
    f32 = np.float32
    sph = np.asarray(spheres, f32)
    dsc = np.asarray(discs, f32)
    S, D = sph.shape[0], dsc.shape[0]
    P = -(-(S + D) // 8) * 8

    def matp(geom_ids):
        mid = np.asarray(mat_id)[np.clip(geom_ids, 0, len(mat_id) - 1)]
        tpk = (np.asarray(mat_type)[mid]
               + 4 * np.asarray(mat_emissive)[mid]).astype(f32)
        return (np.asarray(mat_albedo, f32)[mid], np.asarray(mat_ior, f32)[mid],
                tpk, np.asarray(mat_emission, f32)[mid])

    ap = np.zeros((P, 16), f32)
    apay = np.zeros((16, P), f32)

    s_kind = np.where(sph[:, 3] > 0.0, f32(1.0), f32(0.0))
    ap[:S, 0] = s_kind
    ap[:S, 1:4] = sph[:, 0:3]
    ap[:S, 7] = sph[:, 3] * sph[:, 3]
    alb, ior, tpk, em = matp(np.asarray(sphere_geom))
    apay[0:3, :S] = alb.T
    apay[3, :S] = ior
    apay[4, :S] = tpk
    apay[5:8, :S] = em.T
    apay[8:11, :S] = sph[:, 0:3].T
    apay[14, :S] = s_kind

    d_kind = np.where(dsc[:, 6] > 0.0, f32(2.0), f32(0.0))
    ap[S:S + D, 0] = d_kind
    ap[S:S + D, 1:4] = dsc[:, 3:6]
    ap[S:S + D, 4:7] = dsc[:, 0:3]
    ap[S:S + D, 7] = dsc[:, 6] * dsc[:, 6]
    # Disc plane offset |c . n| (f32, summed left to right):
    nc = dsc[:, 0:3] * dsc[:, 3:6]
    ap[S:S + D, 8] = np.abs((nc[:, 0] + nc[:, 1]) + nc[:, 2])
    alb, ior, tpk, em = matp(np.asarray(disc_geom))
    apay[0:3, S:S + D] = alb.T
    apay[3, S:S + D] = ior
    apay[4, S:S + D] = tpk
    apay[5:8, S:S + D] = em.T
    apay[8:11, S:S + D] = dsc[:, 3:6].T
    apay[11:14, S:S + D] = dsc[:, 0:3].T
    apay[14, S:S + D] = d_kind
    return ap, apay


# Leaves of the JAX package's SceneArrays (and its BlockedSceneTables)
# that a TorchScene is made from: the tables and id maps go to the device
# as they are; the sphere, disc and other material leaves only feed
# ap/apay.
_TABLES = ("p", "nrm", "baabb", "saabb", "sgaabb", "tri_geom", "tri_prim",
           "sphere_geom", "disc_geom", "mat_id", "mat_albedo", "mat_type",
           "mat_ior", "mat_emission", "mat_emissive")
_CARRIED = _TABLES + ("spheres", "discs")
# The leaves of the "bvh" and "dense" intersectors, carried as they are
# (spheres and discs also feed ap/apay):
_GEOMETRY = ("verts", "normals", "tri_v", "mesh_first_tri",
             "mesh_has_normals", "geom_type", "geom_index", "spheres",
             "discs")
BVH_DENSE_LEAVES = ("bvh_nodes",) + _GEOMETRY + ("dense_rows", "dense_geom",
                                        "dense_prim")


def pack_bvh_nodes(mins, exts, meta, geom, miss) -> np.ndarray:
    """The threaded BVH as K7 reads it: [N, 8] i32 rows of lo.xyz (f32
    bits), the f16 extents (x | y << 16, z), meta, geom, miss."""
    n = len(mins)
    out = np.zeros((n, 8), np.int32)
    out[:, 0:3] = np.ascontiguousarray(mins, np.float32).view(np.int32)
    e = np.zeros((n, 4), np.float16)
    e[:, 0:3] = exts
    out[:, 3:5] = e.view(np.int32)
    out[:, 5] = meta
    out[:, 6] = geom
    out[:, 7] = miss
    return out


def _from_leaves(leaves: dict, device, payload_split: bool | None = None,
                 vmem_mode: bool | None = None) -> TorchScene:
    """Build a TorchScene from numpy leaves named as in ``_CARRIED``; the
    sphere/disc tables are derived here, and the padded boxes (``pbox``)
    for a VMEM-mode scene. ``payload_split`` and ``vmem_mode`` None: the
    leaves' own flags (set by :func:`compile_scene`; VMEM mode when
    absent)."""
    if payload_split is None:
        payload_split = bool(leaves.get("payload_split", False))
    if vmem_mode is None:
        vmem_mode = bool(leaves.get("vmem_mode", True))
    ap, apay = analytic_tables(
        leaves["spheres"], leaves["discs"], leaves["sphere_geom"],
        leaves["disc_geom"], leaves["mat_id"], leaves["mat_albedo"],
        leaves["mat_ior"], leaves["mat_type"], leaves["mat_emissive"],
        leaves["mat_emission"])
    keys = _TABLES + (BVH_DENSE_LEAVES if leaves.get("bvh_nodes") is not None
                      else ())
    t = {k: torch.from_numpy(np.array(leaves[k])).to(device)
         for k in keys if leaves.get(k) is not None}
    if leaves.get("root_box") is not None:
        t["root_box"] = torch.from_numpy(
            np.array(leaves["root_box"], np.float32)).to(device)
    return TorchScene(ap=torch.from_numpy(ap).to(device),
                      pbox=(padded_boxes(t["p"], t["baabb"]) if vmem_mode
                            else None),
                      apay=torch.from_numpy(apay).to(device),
                      payload_split=bool(payload_split), **t)


def from_jax_arrays(leaves: dict[str, np.ndarray], device) -> TorchScene:
    """Carry a JAX ``SceneArrays`` across to the port.

    ``leaves`` maps leaf names to numpy arrays: the SceneArrays fields and
    the fields of its ``blocked`` tables flattened into one dict (as
    ``{**arrays._asdict(), **arrays.blocked._asdict()}`` after
    ``np.asarray``). The leaves the megakernel path reads are kept, and
    those of the "bvh" and "dense" routes wherever ``leaves`` holds them:
    the BVH (``bvh_min``, ...) and the geometry, and the dense tables
    from ``leaves["dense"]`` (the JAX ``DenseTables``; None or absent
    where it skipped them).
    Above its VMEM ceiling the JAX package builds no ``p``/``nrm``; they
    are then unpacked from its ``pn8`` (and ``pay8``) super slabs, and the
    scene is an HBM-mode scene (no ``pbox``)."""
    leaves = dict(leaves)
    vmem_mode = leaves.get("p") is not None
    if (leaves.get("p") is None and leaves.get("nrm") is None
            and leaves.get("pn8") is not None):
        leaves["p"], leaves["nrm"] = unpack_super_slabs(
            np.asarray(leaves["pn8"]), leaves.get("pay8"))
    missing = [k for k in _CARRIED if leaves.get(k) is None]
    if missing:
        raise KeyError(f"from_jax_arrays: missing leaves {missing}")
    carried = {k: np.asarray(leaves[k]) for k in _CARRIED}
    if leaves.get("bvh_min") is not None:
        carried["root_box"] = root_box(np.asarray(leaves["bvh_min"]),
                                       np.asarray(leaves["bvh_ext"]))
    if leaves.get("bvh_miss") is not None:
        carried["bvh_nodes"] = pack_bvh_nodes(
            *(np.asarray(leaves[f"bvh_{k}"])
              for k in ("min", "ext", "meta", "geom", "miss")))
        carried.update({k: np.asarray(leaves[k]) for k in _GEOMETRY})
    dt = leaves.get("dense")
    if dt is not None:
        carried.update(dense_leaves(
            {k: np.asarray(v) for k, v in dt._asdict().items()}))
    return _from_leaves(carried, device,
                        leaves.get("pay8") is not None, vmem_mode)


def root_box(mins: np.ndarray, exts: np.ndarray) -> np.ndarray:
    """[2, 3] f32: the root node's min corner and its f16 extent as f32."""
    return np.stack([mins[0], exts[0].astype(np.float32)]).astype(np.float32)


def unpack_super_slabs(pn8: np.ndarray, pay8=None):
    """(p [nb*TB, 16], nrm [8, nb*3*TB]) f32 from the JAX package's HBM
    super slabs (its tables.py pn8/pay8 contract): each super's SB blocks
    sit side by side in ``pn8``'s TB p rows; the members' nrm chunks
    follow below them, or lie in the bf16 ``pay8`` table [nb*24, TB]."""
    w = SB * 16
    if pay8 is None:
        sup = pn8.reshape(-1, TB + SB * 3 * 8, w)
        chunks = sup[:, TB:, :]
    else:
        sup = pn8.reshape(-1, TB, w)
        chunks = np.asarray(pay8).astype(np.float32)
    ns = sup.shape[0]
    nb = ns * SB
    p = (sup[:, :TB, :].reshape(ns, TB, SB, 16).transpose(0, 2, 1, 3)
         .reshape(nb * TB, 16))
    nrm = (chunks.reshape(nb * 3, 8, TB).transpose(1, 0, 2)
           .reshape(8, nb * 3 * TB))
    return (np.ascontiguousarray(p, np.float32),
            np.ascontiguousarray(nrm, np.float32))


def _pad_rows(a: np.ndarray, min_rows: int = 1) -> np.ndarray:
    """Ensure at least min_rows rows (zero-size arrays are awkward on device)."""
    if len(a) >= min_rows:
        return a
    pad = np.zeros((min_rows - len(a),) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad]) if len(a) else pad


def build_scene(
    scene: SceneDescription,
    *,
    device: torch.device | str | None = None,
    image_width: int = 768,
    image_height: int = 432,
    window: CropWindow | None = None,
    samples_per_pixel: int = 256,
    intersector: str = "auto",
    max_path_length: int = MAX_PATH_LENGTH,
    anti_alias_scale: float = ANTI_ALIAS_SCALE,
    roulette_start_depth: int = ROULETTE_START_DEPTH,
    rng_seed: int = RNG_SEED,
    payload_split: bool | None = None,
) -> tuple[TorchScene, SceneParams]:
    """Compile a SceneDescription of any size into device tensors + static
    params. ``device`` None means the CUDA card, which must be present;
    pass ``"cpu"`` for the plain versions.

    ``intersector``: ``"pallas"`` (the VMEM-mode walk), ``"pallas-hbm"``
    (the HBM-mode walk), ``"auto"`` (``"pallas"`` up to
    ``VMEM_TABLE_MAX_TRIS`` triangles + spheres + discs, else
    ``"pallas-hbm"``), ``"bvh"`` (the threaded-BVH walk) or ``"dense"``
    (every triangle; its tables above ``DENSE_TABLE_MAX_TRIS`` only when
    asked for by name). ``payload_split`` (HBM mode only): round the
    payload to bf16 as the JAX package's ``pay8`` does; None turns it on
    above ``HBM_SPLIT_MIN_TRIS`` padded triangle rows.

    ``anti_alias_scale`` (the camera jitter's std-dev in pixels),
    ``roulette_start_depth`` and ``rng_seed`` go into the params as the
    JAX package's ``build_scene`` takes them. The scene BVH keeps one
    primitive per leaf (``bvh.builder.MAX_LEAF_SIZE``), the reference's
    build."""
    if device is None:
        device = cuda_device()
    leaves, params = compile_scene(
        scene, image_width=image_width, image_height=image_height,
        window=window, samples_per_pixel=samples_per_pixel,
        intersector=intersector, max_path_length=max_path_length,
        anti_alias_scale=anti_alias_scale,
        roulette_start_depth=roulette_start_depth, rng_seed=rng_seed,
        payload_split=payload_split)
    return _from_leaves(leaves, device), params


def resolve_intersector(intersector: str, n_prims: int) -> str:
    """The JAX package's choice on its accelerator (its build.py:246);
    ``"bvh"`` and ``"dense"`` only by name."""
    if intersector == "auto":
        return "pallas" if n_prims <= VMEM_TABLE_MAX_TRIS else "pallas-hbm"
    if intersector not in INTERSECTORS:
        raise ValueError(f"unknown intersector {intersector!r}")
    return intersector


def compile_scene(
    scene: SceneDescription,
    *,
    image_width: int,
    image_height: int,
    window: CropWindow | None,
    samples_per_pixel: int,
    intersector: str = "auto",
    max_path_length: int = MAX_PATH_LENGTH,
    anti_alias_scale: float = ANTI_ALIAS_SCALE,
    roulette_start_depth: int = ROULETTE_START_DEPTH,
    rng_seed: int = RNG_SEED,
    payload_split: bool | None = None,
) -> tuple[dict[str, np.ndarray], SceneParams]:
    """The host half of :func:`build_scene` (same arguments): the scene's
    numpy leaves, named as the JAX package's (the blocked tables,
    including the ``baabb32`` leaf no ported kernel reads yet, and the
    sphere, disc and material arrays), with the ``payload_split`` and
    ``vmem_mode`` flags as resolved, and its params."""
    scene.validate()

    tri_list, vert_list, norm_list, mesh_first_tri = [], [], [], []
    vert_base = tri_base = 0
    for m in scene.meshes:
        mesh_first_tri.append(tri_base)
        t32 = m.triangles.astype(np.int32, copy=False)
        tri_list.append(t32 + np.int32(vert_base) if vert_base else t32)
        vert_list.append(m.vertices)
        norm_list.append(m.normals if m.has_normals
                         else np.zeros_like(m.vertices))
        vert_base += len(m.vertices)
        tri_base += len(m.triangles)
    tri_v = (np.concatenate(tri_list) if tri_list
             else np.zeros((0, 3), np.int32))
    verts = (np.concatenate(vert_list) if vert_list
             else np.zeros((0, 3), np.float32))
    normals = (np.concatenate(norm_list) if norm_list
               else np.zeros((0, 3), np.float32))

    num_meshes, S, D = len(scene.meshes), len(scene.spheres), len(scene.discs)
    num_geoms = num_meshes + S + D
    intersector = resolve_intersector(intersector, len(tri_v) + S + D)
    if intersector == "pallas":
        if payload_split:
            raise ValueError("payload_split is an HBM-mode option")
        payload_split = False

    # Scene BVH over every primitive (ref: src/app_utils.cpp:145-188); its
    # DFS triangle-leaf order sorts the tables of tri-only scenes:
    lo_list, hi_list, gid_list, pid_list = [], [], [], []
    for gid, m in enumerate(scene.meshes):
        lo, hi = m.triangle_bounds()
        lo_list.append(lo)
        hi_list.append(hi)
        gid_list.append(np.full(len(lo), gid, np.int64))
        pid_list.append(np.arange(len(lo), dtype=np.int64))
    for i, s in enumerate(scene.spheres):
        lo_list.append((s[:3] - s[3])[None])
        hi_list.append((s[:3] + s[3])[None])
        gid_list.append(np.array([num_meshes + i], np.int64))
        pid_list.append(np.zeros(1, np.int64))
    for i, d in enumerate(scene.discs):
        lo_list.append((d[3:6] - d[6])[None])
        hi_list.append((d[3:6] + d[6])[None])
        gid_list.append(np.array([num_meshes + S + i], np.int64))
        pid_list.append(np.zeros(1, np.int64))
    bvh = build_bvh(np.concatenate(lo_list), np.concatenate(hi_list),
                    np.concatenate(gid_list), np.concatenate(pid_list))

    mats = scene.materials
    mat_albedo = np.stack([m.albedo for m in mats]).astype(np.float32)
    mat_emission = np.stack([m.emission for m in mats]).astype(np.float32)
    mat_ior = np.array([m.ior for m in mats], np.float32)
    mat_type = np.array([int(m.type) for m in mats], np.int32)
    mat_emissive = np.array([1 if m.emissive else 0 for m in mats], np.int32)
    mat_id = np.asarray(scene.mat_ids[:num_geoms], np.int32)

    tri_geom_ids = np.concatenate(
        [np.full(len(m.triangles), g, np.int32)
         for g, m in enumerate(scene.meshes)] or [np.zeros(0, np.int32)])
    tri_prim_ids = np.concatenate(
        [np.arange(len(m.triangles), dtype=np.int32)
         for m in scene.meshes] or [np.zeros(0, np.int32)])
    tri_has_normals = np.concatenate(
        [np.full(len(m.triangles), bool(m.has_normals))
         for m in scene.meshes] or [np.zeros(0, bool)])

    # Tri-only scenes reuse the scene BVH's leaf order (bitwise the order a
    # tri-only SAH build gives), and so do mixed scenes above the VMEM
    # ceiling; smaller mixed scenes run the tables' own build:
    tri_order = None
    if len(tri_v) and (not (S or D) or len(tri_v) > VMEM_TABLE_MAX_TRIS):
        leaf = bvh.geom != INVALID_GEOM_ID
        lg = bvh.geom[leaf].astype(np.int64)
        lp = bvh.meta[leaf].astype(np.int64)
        tri_leaf = lg < num_meshes
        tri_order = (np.asarray(mesh_first_tri, np.int64)[lg[tri_leaf]]
                     + lp[tri_leaf])

    blocked = build_blocked_tables(
        tri_v, verts if len(verts) else np.zeros((1, 3), np.float32),
        tri_geom_ids, tri_prim_ids,
        vert_normals=normals if len(normals) else None,
        tri_has_normals=tri_has_normals,
        tri_mat=(mat_id[tri_geom_ids] if len(tri_geom_ids)
                 else np.zeros(0, np.int32)),
        mat_albedo=mat_albedo, mat_ior=mat_ior, mat_type=mat_type,
        mat_emission=mat_emission, mat_emissive=mat_emissive,
        tri_order=tri_order, payload_split=payload_split)

    leaves = dict(blocked._asdict())
    leaves["payload_split"] = bool(
        payload_split if payload_split is not None
        else blocked.p.shape[0] > HBM_SPLIT_MIN_TRIS)
    leaves["vmem_mode"] = intersector == "pallas"
    leaves["root_box"] = root_box(bvh.mins, bvh.exts)
    if intersector in ("bvh", "dense"):
        geom_type = np.array([GEOM_MESH] * num_meshes + [GEOM_SPHERE] * S
                             + [GEOM_DISC] * D, np.int32)
        geom_index = np.concatenate([np.arange(n, dtype=np.int32)
                                     for n in (num_meshes, S, D)])
        leaves.update(
            bvh_nodes=pack_bvh_nodes(bvh.mins, bvh.exts, bvh.meta, bvh.geom,
                                     bvh.miss),
            tri_v=_pad_rows(tri_v), verts=_pad_rows(verts),
            normals=_pad_rows(normals),
            mesh_first_tri=_pad_rows(np.asarray(mesh_first_tri, np.int32)),
            mesh_has_normals=_pad_rows(np.array(
                [1 if m.has_normals else 0 for m in scene.meshes], np.int32)),
            geom_type=_pad_rows(geom_type), geom_index=_pad_rows(geom_index))
        if len(tri_v) <= DENSE_TABLE_MAX_TRIS or intersector == "dense":
            leaves.update(dense_leaves(build_dense_tables(
                tri_v, verts, tri_geom_ids, tri_prim_ids)))
    leaves.update(
        spheres=_pad_rows(scene.spheres), discs=_pad_rows(scene.discs),
        mat_id=_pad_rows(mat_id), mat_albedo=_pad_rows(mat_albedo),
        mat_emission=_pad_rows(mat_emission), mat_ior=_pad_rows(mat_ior),
        mat_type=_pad_rows(mat_type), mat_emissive=_pad_rows(mat_emissive),
        sphere_geom=num_meshes + np.arange(max(S, 1), dtype=np.int32),
        disc_geom=num_meshes + S + np.arange(max(D, 1), dtype=np.int32))

    win = window or CropWindow(image_width, image_height, 0, 0)
    params = SceneParams(
        num_bvh_nodes=bvh.num_nodes,
        bvh_max_depth=bvh.max_depth,
        num_geoms=num_geoms,
        num_meshes=num_meshes,
        image_width=image_width,
        image_height=image_height,
        fov_radians=float(scene.camera.horizontal_fov),
        anti_alias_scale=float(anti_alias_scale),
        max_path_length=int(max_path_length),
        roulette_start_depth=int(roulette_start_depth),
        samples_per_pixel=int(samples_per_pixel),
        rng_seed=int(rng_seed),
        window_w=win.w,
        window_h=win.h,
        window_c=win.c,
        window_r=win.r,
        path_trace=scene.path_trace is not None,
        intersector=intersector,
    )
    return leaves, params
