"""PCD file I/O — the checkpoint format of the reference.

The reference persists its map as PCD files on shutdown and reloads them in
localization mode (ref: src/mapOptmization.h:485-521 save, :245-260 load).
Supports ascii and binary encodings for the field layouts the reference
writes: PointXYZI (x y z intensity) and PointXYZIRPYT (6-DoF keyframe poses).

The port's copy of the JAX package's NumPy `io/pcd.py` (which imports no
JAX; the port imports none of the JAX package).
"""

from __future__ import annotations

import numpy as np

_PCD_DTYPES = {("F", 4): "f4", ("F", 8): "f8",
               ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4",
               ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def read_pcd(path: str) -> dict:
    """Read a PCD file -> dict of field name -> np array (flattened)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val.split()
            if key == "DATA":
                data_mode = val.strip()
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])

        np_fields = []
        for name, t, s, c in zip(fields, types, sizes, counts):
            base = _PCD_DTYPES[(t, s)]
            if c == 1:
                np_fields.append((name, base))
            else:
                np_fields.append((name, base, (c,)))
        dt = np.dtype(np_fields)

        if data_mode == "binary":
            arr = np.frombuffer(f.read(dt.itemsize * n), dtype=dt, count=n)
        elif data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = np.atleast_2d(raw)
            arr = np.zeros(n, dtype=dt)
            col = 0
            for name, t, s, c in zip(fields, types, sizes, counts):
                take = raw[:, col:col + c]
                arr[name] = take[:, 0] if c == 1 else take
                col += c
        else:
            raise ValueError(f"unsupported PCD DATA mode {data_mode!r}")
    return {name: np.asarray(arr[name]) for name in fields}


def write_pcd(path: str, fields: dict, binary: bool = True):
    """Write dict of name -> [N] (or [N,C]) arrays as a PCD file."""
    names = list(fields)
    n = len(next(iter(fields.values())))
    np_fields, sizes, types, counts = [], [], [], []
    for name in names:
        a = np.asarray(fields[name])
        if a.dtype == np.float64:
            a = a.astype(np.float64)
        c = 1 if a.ndim == 1 else a.shape[1]
        kind = {"f": "F", "i": "I", "u": "U"}[a.dtype.kind]
        sizes.append(str(a.dtype.itemsize))
        types.append(kind)
        counts.append(str(c))
        np_fields.append((name, a.dtype.str) if c == 1 else (name, a.dtype.str, (c,)))
        fields[name] = a
    dt = np.dtype(np_fields)
    rec = np.zeros(n, dtype=dt)
    for name in names:
        rec[name] = fields[name]

    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(names)}\n"
        f"SIZE {' '.join(sizes)}\n"
        f"TYPE {' '.join(types)}\n"
        f"COUNT {' '.join(counts)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(rec.tobytes())
        else:
            for row in rec:
                vals = []
                for name in names:
                    v = row[name]
                    vals.extend(np.atleast_1d(v).tolist())
                f.write((" ".join(repr(float(v)) for v in vals) + "\n").encode())
