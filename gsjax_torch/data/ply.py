"""Minimal PLY I/O (binary little-endian + ascii read), replacing the
reference's plyfile dependency (scene/gaussian_model.py:472-611,
dataset_readers.py:fetchPly/storePly).

A copy of `gsjax/data/ply.py`: numpy only, so the port needs no gsjax import.
"""

from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def read_ply(path) -> dict[str, np.ndarray]:
    """Read the 'vertex' element into a dict of column arrays.
    List properties (e.g. face indices) are returned for the 'face' element
    under key '__faces__' when present (uchar-count + int32 indices only)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply", f"not a ply file: {path}"
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) or ('list', ...)])
        while True:
            line = f.readline().strip().decode("ascii")
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                elements.append((name, int(cnt), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(("__list__", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]]))
            elif line == "end_header":
                break

        out: dict[str, np.ndarray] = {}
        for name, cnt, props in elements:
            if any(p[0] == "__list__" for p in props):
                assert len(props) == 1, "mixed list/scalar elements unsupported"
                _, cnt_t, idx_t, _pname = props[0]
                if fmt == "ascii":
                    rows = [np.array(f.readline().split(), dtype=np.float64)[1:]
                            for _ in range(cnt)]
                    faces = np.array(rows, dtype=np.int64)
                else:
                    ct = np.dtype(_PLY_TYPES[cnt_t])
                    it = np.dtype(_PLY_TYPES[idx_t])
                    first = np.frombuffer(f.peek(ct.itemsize)[:ct.itemsize], ct)[0]
                    rec = np.dtype([("n", ct), ("v", it, int(first))])
                    data = np.frombuffer(f.read(cnt * rec.itemsize), rec)
                    faces = data["v"].astype(np.int64)
                if name == "face":
                    out["__faces__"] = faces
                continue
            dt = np.dtype([(p[0], "<" + p[1]) for p in props])
            if fmt == "ascii":
                data = np.loadtxt([f.readline() for _ in range(cnt)],
                                  dtype=np.float64).reshape(cnt, len(props))
                for i, p in enumerate(props):
                    out[p[0]] = data[:, i]
            else:
                data = np.frombuffer(f.read(cnt * dt.itemsize), dt)
                for p in props:
                    out[p[0]] = np.ascontiguousarray(data[p[0]])
        return out


def write_ply(path, columns: dict[str, np.ndarray], faces: np.ndarray | None = None):
    """Write vertex columns (all same length, dtype inferred) + optional
    [F,3] int faces as binary little-endian PLY."""
    names = list(columns.keys())
    n = len(columns[names[0]])
    inv = {v: k for k, v in _PLY_TYPES.items() if not k[0].isdigit()}
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    dt = []
    for k in names:
        col = np.asarray(columns[k])
        t = np.dtype(col.dtype).str.lstrip("<>=|")
        header.append(f"property {inv[t]} {k}")
        dt.append((k, "<" + t))
    if faces is not None:
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")
    rec = np.empty(n, dtype=np.dtype(dt))
    for k in names:
        rec[k] = np.asarray(columns[k])
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
        if faces is not None:
            frec = np.empty(len(faces), dtype=np.dtype([("n", "u1"), ("v", "<i4", 3)]))
            frec["n"] = 3
            frec["v"] = np.asarray(faces, np.int32)
            f.write(frec.tobytes())


def read_pointcloud(path):
    """-> (points [N,3], colors [N,3] in [0,1], normals [N,3])."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "red" in v:
        colors = np.stack([v["red"], v["green"], v["blue"]], axis=1)
        colors = colors.astype(np.float32)
        if colors.max() > 1.0 + 1e-6:
            colors = colors / 255.0
    else:
        colors = np.full_like(pts, 0.5)
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, colors, normals


def write_pointcloud(path, xyz, rgb_uint8=None, normals=None):
    cols = dict(x=xyz[:, 0].astype(np.float32), y=xyz[:, 1].astype(np.float32),
                z=xyz[:, 2].astype(np.float32))
    nm = normals if normals is not None else np.zeros_like(xyz)
    cols.update(nx=nm[:, 0].astype(np.float32), ny=nm[:, 1].astype(np.float32),
                nz=nm[:, 2].astype(np.float32))
    if rgb_uint8 is not None:
        cols.update(red=rgb_uint8[:, 0].astype(np.uint8),
                    green=rgb_uint8[:, 1].astype(np.uint8),
                    blue=rgb_uint8[:, 2].astype(np.uint8))
    write_ply(path, cols)
