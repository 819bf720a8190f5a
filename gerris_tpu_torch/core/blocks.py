"""Morton block tables: the host-side AMR bookkeeping (port of
gerris_tpu/core/blocks.py).

Host numpy and C++, no tensors: the Morton keys, the 2:1 grading
fixpoint (gfs_domain_reshape, src/adaptive.c:998-1022), the refine /
coarsen marks and the neighbour lookup (ftt_cell_neighbor,
src/ftt.h:432-530).  The heavy loops run in native/block_table.cpp,
which ``_lib`` compiles with g++ at first use into
``build/gerris_tpu_torch/`` beside the CUDA kernels (nothing is written
under native/).  The grading, the marks and the neighbour lookup raise
without that library: the numpy versions below (``_grade_py``,
``_apply_marks_py``, ``_neighbors_py``) are the tests' oracle only, since
the reference's numpy grading does not give its native one's mesh on
every layout.  The Morton keys, exact either way, take ``native=False``
for the numpy version.

A block key packs (level << 56 | morton); keys sort in (level, Morton)
order.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "block_table.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gerris_tpu_torch"


def library_path() -> Path:
    """The shared library built from native/block_table.cpp, named by a
    hash of the source so that an edited source is rebuilt."""
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libblocktable-{digest}.so"


_BUILD_ERROR = []


@lru_cache(maxsize=1)
def _lib():
    """Build (g++, at first use, into build/gerris_tpu_torch/) and load the
    block-table library; None without a C++ toolchain (the reason kept
    for ``_native``)."""
    so = library_path()
    try:
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(_SRC),
                            "-o", str(tmp)], check=True, capture_output=True,
                           text=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except subprocess.CalledProcessError as e:
        _BUILD_ERROR.append(f"g++ failed: {e.stderr.strip()[-2000:]}")
        return None
    except OSError as e:
        _BUILD_ERROR.append(f"{type(e).__name__}: {e}")
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.morton_encode_2d.argtypes = [i64p, i64p, ctypes.c_int64, i64p]
    lib.morton_decode_2d.argtypes = [i64p, ctypes.c_int64, i64p, i64p]
    lib.morton_encode_3d.argtypes = [i64p, i64p, i64p, ctypes.c_int64, i64p]
    lib.morton_decode_3d.argtypes = [i64p, ctypes.c_int64, i64p, i64p, i64p]
    lib.grade_2to1_2d.restype = ctypes.c_int64
    lib.grade_2to1_2d.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64, i64p]
    lib.apply_marks_2d.restype = ctypes.c_int64
    lib.apply_marks_2d.argtypes = [i64p, i8p, ctypes.c_int64,
                                   ctypes.c_int64, i64p]
    lib.neighbors_2d.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64, i64p, i8p]
    return lib


def native_loaded() -> bool:
    """Whether the C++ block-table library built and loaded."""
    return _lib() is not None


def _native():
    """The block-table library, or RuntimeError when it cannot be built
    or loaded (the grading and the neighbour tables have no runtime
    fallback)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(
            f"the block-table library {library_path()} could not be built "
            f"from {_SRC} ({'; '.join(_BUILD_ERROR) or 'no reason kept'}); "
            f"the AMR block layouts need it (a C++ compiler, g++)")
    return lib


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _p8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


# -- pure-python versions (the tests' oracle; the Morton keys' fallback) --

def _part1by1(x):
    x = np.asarray(x, np.uint64) & np.uint64(0xffffffff)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000ffff0000ffff)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00ff00ff00ff00ff)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0f0f0f0f0f0f0f0f)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def _unpart1by1(x):
    x = np.asarray(x, np.uint64) & np.uint64(0x5555555555555555)
    x = (x | (x >> np.uint64(1))) & np.uint64(0x3333333333333333)
    x = (x | (x >> np.uint64(2))) & np.uint64(0x0f0f0f0f0f0f0f0f)
    x = (x | (x >> np.uint64(4))) & np.uint64(0x00ff00ff00ff00ff)
    x = (x | (x >> np.uint64(8))) & np.uint64(0x0000ffff0000ffff)
    x = (x | (x >> np.uint64(16))) & np.uint64(0x00000000ffffffff)
    return x


def morton_encode_2d(ix, iy, native: bool = True):
    ix = np.ascontiguousarray(ix, np.int64)
    iy = np.ascontiguousarray(iy, np.int64)
    lib = _lib() if native else None
    if lib is not None:
        out = np.empty_like(ix)
        lib.morton_encode_2d(_p64(ix), _p64(iy), len(ix), _p64(out))
        return out
    return (_part1by1(ix) | (_part1by1(iy) << np.uint64(1))).astype(np.int64)


def morton_decode_2d(code, native: bool = True):
    code = np.ascontiguousarray(code, np.int64)
    lib = _lib() if native else None
    if lib is not None:
        ix = np.empty_like(code)
        iy = np.empty_like(code)
        lib.morton_decode_2d(_p64(code), len(code), _p64(ix), _p64(iy))
        return ix, iy
    c = code.astype(np.uint64)
    return (_unpart1by1(c).astype(np.int64),
            _unpart1by1(c >> np.uint64(1)).astype(np.int64))


def make_key(level, morton):
    return (np.asarray(level, np.int64) << np.int64(56)) | \
        np.asarray(morton, np.int64)


def key_level(keys):
    return (np.asarray(keys, np.int64) >> np.int64(56)).astype(np.int32)


def key_morton(keys):
    return np.asarray(keys, np.int64) & np.int64(0xffffffffffffff)


class BlockLayout:
    """A set of leaf blocks (keys sorted in (level, Morton) order).

    root: number of root blocks per axis (the box stack).
    """

    def __init__(self, keys, root=(1, 1)):
        self.keys = np.sort(np.asarray(keys, np.int64))
        self.root = tuple(root)

    @staticmethod
    def uniform(level: int, root=(1, 1)) -> "BlockLayout":
        nx = root[0] << level
        ny = root[1] << level
        ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        m = morton_encode_2d(ix.ravel(), iy.ravel())
        return BlockLayout(make_key(level, m), root)

    def __len__(self):
        return len(self.keys)

    def coords(self):
        lev = key_level(self.keys)
        ix, iy = morton_decode_2d(key_morton(self.keys))
        return lev, ix, iy

    def apply_marks(self, marks) -> "BlockLayout":
        """+1 refine, -1 coarsen candidate (all 4 siblings must agree), 0
        keep.  Reference: adapt_local refine/coarsen, src/adaptive.c:1402."""
        marks = np.ascontiguousarray(marks, np.int8)
        lib = _native()
        cap = 4 * len(self.keys) + 16
        out = np.empty(cap, np.int64)
        n = lib.apply_marks_2d(_p64(self.keys), _p8(marks), len(self.keys),
                               cap, _p64(out))
        assert n >= 0
        return BlockLayout(out[:n], self.root)

    def _apply_marks_py(self, marks):
        lev, ix, iy = self.coords()
        out = []
        votes = {}
        for i in range(len(self.keys)):
            if marks[i] < 0 and lev[i] > 0:
                pk = int(make_key(lev[i] - 1,
                                  morton_encode_2d([ix[i] >> 1],
                                                   [iy[i] >> 1])[0]))
                votes[pk] = votes.get(pk, 0) + 1
        for i in range(len(self.keys)):
            l, x, y = int(lev[i]), int(ix[i]), int(iy[i])
            if marks[i] > 0:
                for cc in range(4):
                    fx, fy = 2 * x + (cc & 1), 2 * y + (cc >> 1)
                    out.append(int(make_key(
                        l + 1, morton_encode_2d([fx], [fy])[0])))
            elif marks[i] < 0 and l > 0:
                pk = int(make_key(l - 1, morton_encode_2d([x >> 1],
                                                          [y >> 1])[0]))
                if votes.get(pk) == 4:
                    if (x & 1) == 0 and (y & 1) == 0:
                        out.append(pk)
                else:
                    out.append(int(self.keys[i]))
            else:
                out.append(int(self.keys[i]))
        return np.asarray(out, np.int64)

    def grade(self) -> "BlockLayout":
        """Enforce 2:1 balance incl. corners (gfs_domain_reshape fixpoint,
        src/adaptive.c:998-1022)."""
        lib = _native()
        cap = 16 * len(self.keys) + 64
        out = np.empty(cap, np.int64)
        n = lib.grade_2to1_2d(_p64(self.keys), len(self.keys), self.root[0],
                              self.root[1], cap, _p64(out))
        assert n >= 0
        return BlockLayout(out[:n], self.root)

    def _grade_py(self):
        leaves = set(int(k) for k in self.keys)

        def cover(l, x, y):
            while l >= 0:
                k = int(make_key(l, morton_encode_2d([x], [y],
                                                     native=False)[0]))
                if k in leaves:
                    return l, x, y, k
                x >>= 1
                y >>= 1
                l -= 1
            return None

        changed = True
        while changed:
            changed = False
            for k in list(leaves):
                l = int(key_level([k])[0])
                if l == 0:
                    continue
                x, y = (int(v[0]) for v in
                        morton_decode_2d(key_morton([k])))
                nx, ny = self.root[0] << l, self.root[1] << l
                for dx in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        if dx == 0 and dy == 0:
                            continue
                        qx, qy = x + dx, y + dy
                        if not (0 <= qx < nx and 0 <= qy < ny):
                            continue
                        c = cover(l, qx, qy)
                        if c is not None and c[0] >= l - 1:
                            continue
                        finer = any(int(make_key(
                            l + 1, morton_encode_2d([2 * qx + (cc & 1)],
                                                    [2 * qy + (cc >> 1)],
                                                    native=False)[0]))
                            in leaves for cc in range(4))
                        if finer:
                            continue
                        if c is None:
                            continue
                        cl, cx2, cy2, ck = c
                        leaves.remove(ck)
                        for cc in range(4):
                            fx, fy = 2 * cx2 + (cc & 1), 2 * cy2 + (cc >> 1)
                            leaves.add(int(make_key(
                                cl + 1, morton_encode_2d(
                                    [fx], [fy], native=False)[0])))
                        changed = True
        return np.asarray(sorted(leaves), np.int64)

    def neighbors(self):
        """(idx, delta) arrays of shape (n, 4) for directions -x,+x,-y,+y:
        covering-leaf slot index (-1 = domain boundary) and level delta.
        Reference: ftt_cell_neighbor (src/ftt.h:432-530)."""
        lib = _native()
        n = len(self.keys)
        idx = np.zeros((n, 4), np.int64)
        delta = np.zeros((n, 4), np.int8)
        lib.neighbors_2d(_p64(self.keys), n, self.root[0], self.root[1],
                         _p64(idx), _p8(delta))
        return idx, delta

    def _neighbors_py(self):
        slot = {int(k): i for i, k in enumerate(self.keys)}
        lev, ix, iy = self.coords()
        n = len(self.keys)
        idx = np.full((n, 4), -1, np.int64)
        delta = np.zeros((n, 4), np.int8)
        dirs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
        for i in range(n):
            l, x, y = int(lev[i]), int(ix[i]), int(iy[i])
            nx, ny = self.root[0] << l, self.root[1] << l
            for d, (dx, dy) in enumerate(dirs):
                qx, qy = x + dx, y + dy
                if not (0 <= qx < nx and 0 <= qy < ny):
                    continue
                k = int(make_key(l, morton_encode_2d([qx], [qy],
                                                     native=False)[0]))
                if k in slot:
                    idx[i, d] = slot[k]
                    continue
                if l > 0:
                    k = int(make_key(l - 1, morton_encode_2d(
                        [qx >> 1], [qy >> 1], native=False)[0]))
                    if k in slot:
                        idx[i, d] = slot[k]
                        delta[i, d] = -1
                        continue
                fx = 2 * qx + (1 if dx < 0 else 0)
                fy = 2 * qy + (1 if dy < 0 else 0)
                k = int(make_key(l + 1, morton_encode_2d([fx], [fy],
                                                         native=False)[0]))
                if k in slot:
                    idx[i, d] = slot[k]
                    delta[i, d] = 1
        return idx, delta
