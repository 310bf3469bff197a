"""Keras-HDF5 reader for the NIF weights, numpy and the standard library
only: a frozen copy of the port's reader, kept here so that the plain
reference reads the weight file with code of its own.

It covers the small subset of HDF5 that the NIF weight files use
(superblock version 0 or 1; old-style groups through symbol tables;
version 1 object headers with continuations; contiguous little-endian
float16/float32 datasets; variable-length string attributes in a global
heap) and raises ``ValueError`` on anything outside it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# Object header message types this reader interprets; every other type
# in a header is skipped (names, times, fill values, alignment):
_MSG_DATASPACE = 0x0001
_MSG_DATATYPE = 0x0003
_MSG_LAYOUT = 0x0008
_MSG_FILTERS = 0x000B
_MSG_ATTRIBUTE = 0x000C
_MSG_CONTINUATION = 0x0010
_MSG_SYMBOL_TABLE = 0x0011
_MSG_LINK = 0x0006          # new-style groups: outside the subset
_MSG_LINK_INFO = 0x0002


@dataclass
class DenseLayer:
    name: str
    activation: str  # "relu" | "linear"/"none"
    kernel: np.ndarray  # [in, out]
    bias: np.ndarray | None
    dtype: str = "float32"


@dataclass
class NifWeights:
    layers: List[DenseLayer] = field(default_factory=list)


class _H5File:
    """The subset reader over the whole file's bytes."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        self.path = path
        if not self.buf.startswith(_SIGNATURE):
            self._fail("no HDF5 signature at offset 0 (user blocks are "
                       "outside the supported subset)")
        version = self.buf[8]
        if version not in (0, 1):
            self._fail(f"superblock version {version} (supported: 0, 1)")
        self.so, self.sl = self.buf[13], self.buf[14]
        if self.so not in (4, 8) or self.sl not in (4, 8):
            self._fail(f"offset/length sizes {self.so}/{self.sl}")
        pos = 24 + (4 if version == 1 else 0)
        self.base = self._off(pos)
        pos += 4 * self.so  # base, free-space, end-of-file, driver info
        self.root = self._symbol_entry(pos)[1]

    # ---- primitive reads ----
    def _fail(self, what: str):
        raise ValueError(f"{self.path}: {what}")

    def _uint(self, pos: int, size: int) -> int:
        if pos < 0 or pos + size > len(self.buf):
            self._fail(f"read past the end of the file at {pos}")
        return int.from_bytes(self.buf[pos:pos + size], "little")

    def _off(self, pos: int) -> int:
        return self._uint(pos, self.so)

    def _len(self, pos: int) -> int:
        return self._uint(pos, self.sl)

    def _addr(self, a: int) -> int:
        return self.base + a

    def _expect(self, pos: int, sig: bytes):
        if self.buf[pos:pos + len(sig)] != sig:
            self._fail(f"expected {sig!r} at {pos}, found "
                       f"{self.buf[pos:pos + len(sig)]!r}")

    def _symbol_entry(self, pos: int) -> tuple[int, int]:
        """(link-name heap offset, object header address)."""
        return self._off(pos), self._off(pos + self.so)

    # ---- object headers ----
    def _messages(self, addr: int) -> list[tuple[int, int, int]]:
        """[(type, data position, size)] of a version-1 object header,
        continuation blocks included."""
        pos = self._addr(addr)
        if self.buf[pos] != 1:
            self._fail(f"object header version {self.buf[pos]} at {addr} "
                       "(supported: 1)")
        n_msgs = self._uint(pos + 2, 2)
        blocks = [(pos + 16, self._uint(pos + 8, 4))]
        out = []
        while blocks:
            start, size = blocks.pop(0)
            p, end = start, start + size
            while p + 8 <= end and len(out) < n_msgs:
                mtype, msize = self._uint(p, 2), self._uint(p + 2, 2)
                data = p + 8
                if mtype == _MSG_CONTINUATION:
                    blocks.append((self._addr(self._off(data)),
                                   self._len(data + self.so)))
                out.append((mtype, data, msize))
                p = data + msize
        return out

    # ---- groups ----
    def _heap_string(self, heap_addr: int, offset: int) -> str:
        pos = self._addr(heap_addr)
        self._expect(pos, b"HEAP")
        data = self._addr(self._off(pos + 8 + 2 * self.sl))
        end = self.buf.index(b"\0", data + offset)
        return self.buf[data + offset:end].decode("utf-8")

    def _group_links(self, header_addr: int) -> dict[str, int]:
        """name -> object header address of an old-style group's members."""
        msgs = self._messages(header_addr)
        types = {t for t, _, _ in msgs}
        if _MSG_LINK in types or _MSG_LINK_INFO in types:
            self._fail("new-style (link message) groups are outside the "
                       "supported subset")
        stab = [d for t, d, _ in msgs if t == _MSG_SYMBOL_TABLE]
        if not stab:
            self._fail(f"object at {header_addr} is not a group")
        btree, heap = self._off(stab[0]), self._off(stab[0] + self.so)
        links: dict[str, int] = {}
        self._walk_btree(btree, heap, links)
        return links

    def _walk_btree(self, addr: int, heap: int, links: dict[str, int]):
        pos = self._addr(addr)
        self._expect(pos, b"TREE")
        if self.buf[pos + 4] != 0:
            self._fail(f"B-tree node type {self.buf[pos + 4]} (supported: "
                       "0, group nodes)")
        level, used = self.buf[pos + 5], self._uint(pos + 6, 2)
        p = pos + 8 + 2 * self.so + self.sl  # past the first key
        for _ in range(used):
            child = self._off(p)
            if level > 0:
                self._walk_btree(child, heap, links)
            else:
                self._read_snod(child, heap, links)
            p += self.so + self.sl
        return links

    def _read_snod(self, addr: int, heap: int, links: dict[str, int]):
        pos = self._addr(addr)
        self._expect(pos, b"SNOD")
        n = self._uint(pos + 6, 2)
        entry = 2 * self.so + 24
        for i in range(n):
            name_off, obj = self._symbol_entry(pos + 8 + i * entry)
            links[self._heap_string(heap, name_off)] = obj

    def resolve(self, path: str) -> int:
        addr = self.root
        for part in [p for p in path.split("/") if p]:
            links = self._group_links(addr)
            if part not in links:
                self._fail(f"no object '{part}' in '{path}'")
            addr = links[part]
        return addr

    # ---- datatypes, dataspaces ----
    def _dtype(self, pos: int) -> tuple[str, int]:
        """(kind, size) of a datatype message: kind is a numpy dtype string
        for floats, 'vlen-str' for a variable-length string."""
        cls = self.buf[pos] & 0x0F
        bits = self._uint(pos + 1, 3)
        size = self._uint(pos + 4, 4)
        if cls == 1:  # IEEE float
            if bits & 1:
                self._fail("big-endian floats are outside the supported subset")
            prec = self._uint(pos + 10, 2)
            esize, msize = self.buf[pos + 13], self.buf[pos + 15]
            bias = self._uint(pos + 16, 4)
            fmt = {(2, 16, 5, 10, 15): "<f2", (4, 32, 8, 23, 127): "<f4"}
            key = (size, prec, esize, msize, bias)
            if key not in fmt:
                self._fail(f"float layout {key} (supported: IEEE f16, f32)")
            return fmt[key], size
        if cls == 9 and bits & 0x0F == 1:  # variable-length string
            return "vlen-str", size
        self._fail(f"datatype class {cls} (supported: float, vlen string)")

    def _shape(self, pos: int) -> tuple[int, ...]:
        version, rank = self.buf[pos], self.buf[pos + 1]
        if version == 1:
            dims = pos + 8
        elif version == 2:
            if self.buf[pos + 3] == 2:  # null dataspace
                return (0,)
            dims = pos + 4
        else:
            self._fail(f"dataspace version {version}")
        return tuple(self._len(dims + i * self.sl) for i in range(rank))

    # ---- datasets and attributes ----
    def dataset(self, path: str) -> np.ndarray:
        msgs = {}
        for t, d, s in self._messages(self.resolve(path)):
            msgs.setdefault(t, d)
        if _MSG_FILTERS in msgs:
            self._fail(f"'{path}' has a filter pipeline (compression is "
                       "outside the supported subset)")
        for need in (_MSG_DATASPACE, _MSG_DATATYPE, _MSG_LAYOUT):
            if need not in msgs:
                self._fail(f"'{path}' is not a dataset")
        shape = self._shape(msgs[_MSG_DATASPACE])
        kind, size = self._dtype(msgs[_MSG_DATATYPE])
        if kind == "vlen-str":
            self._fail(f"'{path}' holds strings, not floats")
        lp = msgs[_MSG_LAYOUT]
        version = self.buf[lp]
        if version == 3:
            if self.buf[lp + 1] != 1:
                self._fail(f"'{path}' layout class {self.buf[lp + 1]} "
                           "(supported: 1, contiguous)")
            addr = self._off(lp + 2)
        elif version in (1, 2):
            if self.buf[lp + 2] != 1:
                self._fail(f"'{path}' layout class {self.buf[lp + 2]} "
                           "(supported: 1, contiguous)")
            addr = self._off(lp + 8)
        else:
            self._fail(f"'{path}' layout message version {version}")
        count = int(np.prod(shape, dtype=np.int64))
        if addr == (1 << (8 * self.so)) - 1:
            self._fail(f"'{path}' has no storage allocated")
        start = self._addr(addr)
        nbytes = count * size
        if start + nbytes > len(self.buf):
            self._fail(f"'{path}' data runs past the end of the file")
        return np.frombuffer(self.buf, np.dtype(kind), count,
                             start).reshape(shape).copy()

    def attribute(self, obj_path: str, name: str) -> str:
        """A variable-length string attribute of an object."""
        for t, d, _ in self._messages(self.resolve(obj_path)):
            if t != _MSG_ATTRIBUTE:
                continue
            version = self.buf[d]
            nsize, tsize, ssize = (self._uint(d + 2, 2), self._uint(d + 4, 2),
                                   self._uint(d + 6, 2))
            if version == 1:
                pad = lambda n: -(-n // 8) * 8
                p_name = d + 8
                p_type = p_name + pad(nsize)
                p_space = p_type + pad(tsize)
                p_data = p_space + pad(ssize)
            elif version in (2, 3):
                p_name = d + 8 + (1 if version == 3 else 0)
                p_type = p_name + nsize
                p_space = p_type + tsize
                p_data = p_space + ssize
            else:
                self._fail(f"attribute message version {version}")
            aname = self.buf[p_name:p_name + nsize].split(b"\0")[0].decode()
            if aname != name:
                continue
            kind, _ = self._dtype(p_type)
            if kind != "vlen-str":
                self._fail(f"attribute '{name}' is not a variable-length "
                           "string")
            if self._shape(p_space) not in ((), (1,)):
                self._fail(f"attribute '{name}' is not a scalar")
            length = self._uint(p_data, 4)
            gcol = self._off(p_data + 4)
            index = self._uint(p_data + 4 + self.so, 4)
            return self._global_heap(gcol, index)[:length].decode("utf-8")
        self._fail(f"no attribute '{name}' on '{obj_path or '/'}'")

    def _global_heap(self, addr: int, index: int) -> bytes:
        pos = self._addr(addr)
        self._expect(pos, b"GCOL")
        end = pos + self._len(pos + 8)
        p = pos + 8 + self.sl
        while p + 8 + self.sl <= end:
            obj_index = self._uint(p, 2)
            size = self._len(p + 8)
            if obj_index == 0:
                break
            data = p + 8 + self.sl
            if obj_index == index:
                return self.buf[data:data + size]
            p = data + -(-size // 8) * 8
        self._fail(f"global heap object {index} not found at {addr}")


def load_keras_h5(path: str) -> NifWeights:
    """The Dense layers of a Keras Functional model saved as ``.h5`` (the
    same values the JAX package's h5py loader returns)."""
    f = _H5File(path)
    cfg = json.loads(f.attribute("/", "model_config"))
    if cfg.get("class_name") != "Functional":
        raise ValueError("Expected a Keras 'Functional' model")
    weights = NifWeights()
    for layer in cfg["config"]["layers"]:
        cn = layer["class_name"]
        if cn in ("InputLayer", "Concatenate"):
            continue
        if cn != "Dense":
            raise ValueError(f"Layer class '{cn}' not supported by NIF loader")
        lc = layer["config"]
        name = lc["name"]
        kernel = f.dataset(f"/model_weights/{name}/{name}/kernel:0")
        bias = None
        if lc.get("use_bias", True):
            bias = f.dataset(f"/model_weights/{name}/{name}/bias:0")
        act = lc.get("activation", "linear")
        weights.layers.append(DenseLayer(
            name=name, activation="none" if act == "linear" else act,
            kernel=kernel, bias=bias, dtype=str(kernel.dtype)))
    return weights
