"""Inputs of the unsharp mask on which the rounding of ``s + a * d``
matters: shared by the CPU parity tests and the card's kernel tests (this
module imports neither jax nor the reference package)."""
import numpy as np


def fma_cases(limit=64):
    """(a, s, d, separate, fused): float32 amounts a within a few ulps of
    (m + 0.5 - s) / d, where ``floor(s + fl32(a*d) + 0.5)`` (separate
    roundings) and ``floor(fl32(s + a*d) + 0.5)`` (one, as an FMA gives)
    differ, both inside [0, 255], with blur = s - d a pixel value."""
    hits = []
    for dv in (*range(-255, 0), *range(1, 256)):
        sv = np.arange(max(0, dv), min(255, 255 + dv) + 1)
        S, M = np.meshgrid(sv, np.arange(-300, 600), indexing="ij")
        a0 = (M + 0.5 - S) / dv
        ok = (a0 > 0.01) & (a0 <= 0.3)
        S, a0 = S[ok], a0[ok].astype(np.float32)
        for k in range(-3, 4):
            a = a0
            for _ in range(abs(k)):
                a = np.nextafter(a, np.float32(np.inf if k > 0 else -np.inf))
            sep = np.floor((S.astype(np.float32) + a * np.float32(dv))
                           + np.float32(0.5))
            fused = np.floor((S + a.astype(np.float64) * dv)
                             .astype(np.float32) + np.float32(0.5))
            idx = np.nonzero((sep != fused) & (sep >= 0) & (sep <= 255)
                             & (fused >= 0) & (fused <= 255))[0]
            hits += [(float(a[i]), int(S[i]), dv, int(sep[i]),
                      int(fused[i])) for i in idx[:2]]
        if len(hits) >= limit:
            return hits
    return hits
