"""Reader for the simple record stream emitted by the tools/dump_*.c
oracles: [u32 name_len][name][u32 elem_size][u32 ndim][u32 dims...][data].
elem_size 2 -> uint16 (pixels/cdf) unless name hints int16; 4 -> int32."""
from __future__ import annotations

import struct

import numpy as np


def parse_records(path: str, int16_names: tuple[str, ...] = ()) -> dict:
    out = {}
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (nl,) = struct.unpack_from("<I", data, pos)
        pos += 4
        name = data[pos : pos + nl].decode()
        pos += nl
        es, nd = struct.unpack_from("<II", data, pos)
        pos += 8
        dims = struct.unpack_from(f"<{nd}I", data, pos)
        pos += 4 * nd
        total = int(np.prod(dims)) if nd else 1
        if es == 1:
            dt = np.uint8
        elif es == 2:
            dt = np.int16 if name.startswith(int16_names) else np.uint16
        elif es == 8:
            dt = np.float64
        else:
            dt = np.int32
        arr = np.frombuffer(data, dtype=dt, count=total, offset=pos)
        out[name] = arr.reshape(dims).copy()
        pos += total * es
    return out
