"""Binary scene serialisation (scene caching / transport).

Copy of ``ipu_ray_lib_tpu/scene/serial.py`` for the port (no jax).

The reference's serialisation layer exists to move a scene into device
SRAM as one aligned byte stream that is reinterpreted zero-copy on device
(ref: include/serialisation/Serialiser.hpp:16-22, Deserialiser.hpp:31-39).
On TPU the device transport is just a pytree of arrays, so the layer's
remaining job is *persistence*: saving a compiled scene (unified mesh
arrays + compact BVH + materials) so later runs skip the build step —
and doing so in a layout-stable, alignment-checked format.

Format: a little-endian container of aligned sections. BVH nodes are
packed to the reference's exact 24-byte node layout (f32 min xyz, u32
prim/secondChild, 3 x f16 extents, u16 geomID — ref
include/CompactBVH2Node.hpp:52-85) so node compactness is preserved and
testable, exactly like the reference's serialiser unit tests
(tests/test.cpp:122-154). Loads reinterpret sections zero-copy as numpy
views over one mmap-able buffer.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from ..bvh.builder import CompactBvh

_MAGIC = b"TPRS0001"
_ALIGN = 64

NODE_DTYPE = np.dtype(
    {
        "names": ["min_x", "min_y", "min_z", "meta", "dx", "dy", "dz", "geom"],
        "formats": ["<f4", "<f4", "<f4", "<u4", "<f2", "<f2", "<f2", "<u2"],
        "offsets": [0, 4, 8, 12, 16, 18, 20, 22],
        "itemsize": 24,
    }
)


def pack_nodes(bvh: CompactBvh) -> np.ndarray:
    """Pack SoA node arrays into the 24-byte AoS node records."""
    n = bvh.num_nodes
    out = np.zeros(n, NODE_DTYPE)
    out["min_x"] = bvh.mins[:, 0]
    out["min_y"] = bvh.mins[:, 1]
    out["min_z"] = bvh.mins[:, 2]
    out["meta"] = bvh.meta.astype(np.int64).astype(np.uint32)
    out["dx"] = bvh.exts[:, 0]
    out["dy"] = bvh.exts[:, 1]
    out["dz"] = bvh.exts[:, 2]
    out["geom"] = bvh.geom.astype(np.uint16)
    return out


def unpack_nodes(packed: np.ndarray, miss: np.ndarray, max_depth: int) -> CompactBvh:
    mins = np.stack([packed["min_x"], packed["min_y"], packed["min_z"]], axis=1)
    exts = np.stack([packed["dx"], packed["dy"], packed["dz"]], axis=1)
    return CompactBvh(
        mins=np.ascontiguousarray(mins, np.float32),
        exts=np.ascontiguousarray(exts, np.float16),
        meta=packed["meta"].astype(np.int32),
        geom=packed["geom"].astype(np.int32),
        miss=np.asarray(miss, np.int32),
        max_depth=max_depth,
    )


class Serialiser:
    """Appends named numpy arrays with alignment padding (role of the
    reference's Serialiser, redesigned as a named-section container)."""

    def __init__(self):
        self._chunks: list[bytes] = []
        self._toc: list[dict] = []
        self._offset = 0

    def add(self, name: str, array: np.ndarray) -> None:
        pad = (-self._offset) % _ALIGN
        if pad:
            self._chunks.append(b"\x00" * pad)
            self._offset += pad
        data = np.ascontiguousarray(array).tobytes()
        self._toc.append(
            {
                "name": name,
                "offset": self._offset,
                "nbytes": len(data),
                "dtype": array.dtype.str if array.dtype.names is None else "node24",
                "shape": list(array.shape),
            }
        )
        self._chunks.append(data)
        self._offset += len(data)

    def tobytes(self, meta: dict | None = None) -> bytes:
        """Layout: magic | header_len u64 | header | pad-to-align | body.
        Section offsets in the TOC are relative to the body start."""
        header = json.dumps({"toc": self._toc, "meta": meta or {}}).encode()
        prefix_len = len(_MAGIC) + 8 + len(header)
        pad = (-prefix_len) % _ALIGN
        return b"".join(
            [_MAGIC, struct.pack("<Q", len(header)), header, b"\x00" * pad]
            + self._chunks
        )


class Deserialiser:
    """Zero-copy reader: sections come back as numpy views into the buffer
    (role of the reference's in-place deserialiseArrayRef,
    include/serialisation/deserialisation.hpp:31-39)."""

    def __init__(self, buf: bytes | memoryview):
        self._buf = memoryview(buf)
        if bytes(self._buf[: len(_MAGIC)]) != _MAGIC:
            raise ValueError("Bad scene container magic")
        (hlen,) = struct.unpack_from("<Q", self._buf, len(_MAGIC))
        header = bytes(self._buf[len(_MAGIC) + 8 : len(_MAGIC) + 8 + hlen])
        doc = json.loads(header)
        self.meta = doc["meta"]
        prefix_len = len(_MAGIC) + 8 + hlen
        self._body_base = prefix_len + ((-prefix_len) % _ALIGN)
        self._toc = {e["name"]: e for e in doc["toc"]}

    def names(self):
        return list(self._toc)

    def get(self, name: str) -> np.ndarray:
        e = self._toc[name]
        start = self._body_base + e["offset"]
        raw = self._buf[start : start + e["nbytes"]]
        dtype = NODE_DTYPE if e["dtype"] == "node24" else np.dtype(e["dtype"])
        arr = np.frombuffer(raw, dtype=dtype)
        shape = e["shape"]
        if e["dtype"] == "node24":
            return arr  # structured 1-D
        return arr.reshape(shape)


def save_scene_bundle(path: str, *, bvh: CompactBvh, arrays_host: dict,
                      meta: dict | None = None) -> None:
    """Write a compiled scene to disk: packed 24B BVH nodes + miss links +
    every host array needed to rebuild SceneArrays."""
    s = Serialiser()
    s.add("bvh_nodes24", pack_nodes(bvh))
    s.add("bvh_miss", np.asarray(bvh.miss, np.int32))
    for name, arr in arrays_host.items():
        s.add(name, np.asarray(arr))
    m = dict(meta or {})
    m["bvh_max_depth"] = int(bvh.max_depth)
    with open(path, "wb") as f:
        f.write(s.tobytes(m))


def load_scene_bundle(path: str):
    """Load a scene bundle; returns (CompactBvh, dict of arrays, meta)."""
    with open(path, "rb") as f:
        buf = f.read()
    d = Deserialiser(buf)
    bvh = unpack_nodes(d.get("bvh_nodes24"), d.get("bvh_miss"), d.meta["bvh_max_depth"])
    arrays = {
        n: d.get(n) for n in d.names() if n not in ("bvh_nodes24", "bvh_miss")
    }
    return bvh, arrays, d.meta
