"""The port's ``utils/recordio.py`` (the record stream of the tools/dump_*.c
oracles): records written with ``struct`` read back as written, and as the
reference module reads them.
Tolerance: exact equality."""
import struct

import numpy as np

from aom_av1_psy_tpu.utils.recordio import parse_records as ref_parse
from aom_av1_psy_tpu_torch.utils.recordio import parse_records


def _record(name, arr):
    b = name.encode()
    return (struct.pack("<I", len(b)) + b
            + struct.pack("<II", arr.itemsize, arr.ndim)
            + struct.pack(f"<{arr.ndim}I", *arr.shape) + arr.tobytes())


def test_records_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    want = {
        "pix": rng.integers(0, 1024, (4, 6)).astype(np.uint16),
        "coeff_dq": rng.integers(-3000, 3000, (8, 8)).astype(np.int16),
        "bytes": rng.integers(0, 256, 17).astype(np.uint8),
        "lvl": rng.integers(-1 << 30, 1 << 30, (2, 3, 5)).astype(np.int32),
        "cost": rng.standard_normal(9),
        "scalar": np.array(7, np.int32),
    }
    path = tmp_path / "recs.bin"
    path.write_bytes(b"".join(_record(k, v) for k, v in want.items()))
    got = parse_records(str(path), int16_names=("coeff",))
    ref = ref_parse(str(path), int16_names=("coeff",))
    assert list(got) == list(want) == list(ref)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(ref[k], v, err_msg=k)
