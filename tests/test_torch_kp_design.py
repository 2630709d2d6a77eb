"""The premises of kernel KP's design (``csrc/analyze.cu``), held on the
CPU (no card, no jax):

- ``div_magic`` makes floor(a / dq) exactly ``a * mul >> sh`` for every
  dividend 0 <= a < 2^31 at every quantizer step of the tables (and other
  steps), so the kernel's quantizer may divide by a multiply and a shift;
- the stage table's forward DCT programs have the stage counts that KP's
  DCT pass is unrolled over and no stage clamp, and the wrapper refuses a
  table that does not.

The kernel itself is held bit for bit against its plain version by the
``gpu`` tests of ``tests/test_torch_k12_gpu.py``.

Tolerance: exact equality (integers).
"""
import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from aom_av1_psy_tpu_torch.normative import tables
from aom_av1_psy_tpu_torch.ops import analyze as A


def _div_magic(d):
    """``div_magic``: (mul, sh) with mul = ceil(2^(31+l) / d), 2^l >= d."""
    l = 0
    while (1 << l) < d:
        l += 1
    sh = 31 + l
    return ((1 << sh) + d - 1) // d, sh


def test_quantizer_division_by_multiply_is_exact():
    steps = {int(f(q)) for q in range(256)
             for f in (tables.dc_quant, tables.ac_quant)}
    steps |= set(range(1, 2049)) | {(1 << k) + e for k in range(31)
                                    for e in (-1, 0, 1) if (1 << k) + e > 0}
    rng = np.random.default_rng(3)
    for d in sorted(steps):
        mul, sh = _div_magic(d)
        assert mul * ((1 << 31) - 1) < 1 << 64
        k = np.arange(0, 64, dtype=object)
        a = np.concatenate([k, k * d, k * d + d - 1, k * d - 1,
                            rng.integers(0, 1 << 31, 64).astype(object),
                            np.array([(1 << 31) - 1, (1 << 31) - d],
                                     dtype=object)])
        a = a[(a >= 0) & (a < 1 << 31)]
        assert all((x * mul) >> sh == x // d for x in a), d


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_stage_table_fits_the_unrolled_dct_pass(n):
    _, meta = A._kp_programs.__wrapped__(n, "cpu")
    for prog in (0, 2):                 # forward DCT columns, rows
        assert int(meta[4 * prog + 1]) == A.KP_DCT_STAGES[n]
        assert int(meta[4 * prog + 3]) == 0


def test_wrapper_refuses_another_stage_count(monkeypatch):
    real = A.stage_table

    def longer(n):
        stages, meta = real(n)
        meta = meta.copy()
        meta[4 * 2 + 1] += 1            # the row pass one stage longer
        return stages, meta

    monkeypatch.setattr(A, "stage_table", longer)
    with pytest.raises(ValueError, match="KP: forward DCT program 2"):
        A._kp_programs.__wrapped__(16, "cpu")
