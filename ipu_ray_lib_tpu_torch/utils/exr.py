"""Minimal OpenEXR 2.0 codec (uncompressed scanline RGB, float32).

Copy of ``ipu_ray_lib_tpu/utils/exr.py``: the same bytes for the same
image, so the two packages read each other's files.

The environment's OpenCV build has no EXR writer, so the framework carries
its own: enough of the (public) OpenEXR format to round-trip float32 RGB
AOVs — magic/version, attribute header, scanline offset table, and
NO_COMPRESSION scanline blocks.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_PIXEL_FLOAT = 2  # OpenEXR pixel type enum: 0=UINT, 1=HALF, 2=FLOAT
_PIXEL_HALF = 1


def _attr(name: str, type_name: str, payload: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + type_name.encode() + b"\x00"
        + struct.pack("<i", len(payload)) + payload
    )


def _channel_list(names, pixel_type: int) -> bytes:
    out = b""
    for n in sorted(names):  # EXR requires alphabetical channel order
        out += (
            n.encode() + b"\x00"
            + struct.pack("<i", pixel_type)
            + struct.pack("<B3x", 0)       # pLinear + reserved
            + struct.pack("<ii", 1, 1)     # x/y sampling
        )
    return out + b"\x00"


def write_exr(path: str, rgb: np.ndarray) -> None:
    """Write an RGB float32 image as an uncompressed scanline EXR."""
    rgb = np.ascontiguousarray(np.asarray(rgb, np.float32))
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("write_exr expects [H, W, 3]")
    h, w = rgb.shape[:2]

    header = b""
    header += _attr("channels", "chlist", _channel_list(["R", "G", "B"], _PIXEL_FLOAT))
    header += _attr("compression", "compression", struct.pack("<B", 0))  # none
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", struct.pack("<B", 0))  # increasing y
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"  # end of header

    preamble = struct.pack("<ii", _MAGIC, 2)  # version 2, scanline, no tiles
    offset_table_pos = len(preamble) + len(header)
    offset_table_size = 8 * h
    data_start = offset_table_pos + offset_table_size

    line_bytes = 3 * 4 * w
    block_size = 8 + line_bytes  # y + byte count prefix per block
    offsets = [data_start + y * block_size for y in range(h)]

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(header)
        f.write(struct.pack(f"<{h}q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, line_bytes))
            # Channels alphabetical: B, G, R — each a full row.
            f.write(rgb[y, :, 2].tobytes())
            f.write(rgb[y, :, 1].tobytes())
            f.write(rgb[y, :, 0].tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read EXRs written by :func:`write_exr` (uncompressed scanline RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ValueError("Not an EXR file")
    pos = 8

    attrs = {}
    while data[pos] != 0:
        end = data.index(b"\x00", pos)
        name = data[pos:end].decode()
        pos = end + 1
        end = data.index(b"\x00", pos)
        type_name = data[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = (type_name, data[pos : pos + size])
        pos += size
    pos += 1

    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    (compression,) = struct.unpack("<B", attrs["compression"][1])
    if compression != 0:
        raise ValueError("Only uncompressed EXR supported by this reader")

    # Parse channel list:
    chl = attrs["channels"][1]
    cpos = 0
    channels = []
    while chl[cpos] != 0:
        cend = chl.index(b"\x00", cpos)
        cname = chl[cpos:cend].decode()
        cpos = cend + 1
        (ptype,) = struct.unpack_from("<i", chl, cpos)
        cpos += 16
        channels.append((cname, ptype))
    dtypes = {0: np.uint32, 1: np.float16, 2: np.float32}

    pos += 8 * h  # skip offset table
    img = {c: np.empty((h, w), np.float32) for c, _ in channels}
    for _ in range(h):
        y, nbytes = struct.unpack_from("<ii", data, pos)
        pos += 8
        for cname, ptype in channels:  # alphabetical order on disk
            dt = dtypes[ptype]
            row = np.frombuffer(data, dt, w, pos).astype(np.float32)
            img[cname][y - y0] = row
            pos += w * np.dtype(dt).itemsize

    if all(c in img for c in "RGB"):
        return np.stack([img["R"], img["G"], img["B"]], axis=-1)
    first = next(iter(img.values()))
    return first[..., None].repeat(3, axis=-1)
