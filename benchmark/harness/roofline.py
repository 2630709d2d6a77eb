"""The yardstick's arithmetic: published H100 peaks, the least time a
kernel's work needs, and the partition plan's wavefront counted from a
frame's size.

``bound``, ``pick_bytes``, ``step_bytes`` and ``txq_ops`` are copies of
``chip_smoke.py``'s ``bound``, ``_pick_bytes``, ``_step_bytes`` and
``_txq_ops``; the pick's operation count is the smoke's (~4 operations a
predicted pixel, 3 for its squared error: 7 a pixel and candidate).
"""
from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12

# the partition plan's pick calls on one diagonal: (plane group, block
# size, planes a block, candidates K, calls): luma one 32 and four 16
# quads at K = 61; chroma (U and V together) one 16 and four 8 quads at
# K = 7
PICKS = (("luma", 32, 1, 61, 1), ("luma", 16, 1, 61, 4),
         ("chroma", 16, 2, 7, 1), ("chroma", 8, 2, 7, 4))
KC_LAUNCHES = 3          # one loop-filter launch a plane


def bound(n_bytes, ops, fp64_ops=0):
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and the operations over the CUDA-core rate (float64 operations over
    the FP64 rate)."""
    tb = n_bytes / HBM_BYTES_PER_S
    to = ops / CUDA_CORE_OPS_PER_S + fp64_ops / FP64_OPS_PER_S
    return {"bound_ms": 1e3 * max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def txq_ops(B, bs):
    """Operations of B square transform blocks of size bs: forward and
    inverse 2-D transforms (~8 bs^2 log2(bs) butterfly operations) and
    ~20 per coefficient for quantize, dequantize, recon and the rate."""
    return B * bs * bs * (8 * (bs.bit_length() - 1) + 20)


def pick_bytes(B, bs, npl, K):
    """Bytes the pick must move per call: each block's edges (2 bs + 1,
    and 2 bs more of extensions at K = 61), source, cost row and map
    entries read once, its prediction and pick row written once."""
    edges = (4 if K == 61 else 2) * bs + 1
    return 4 * B * (npl * (edges + 2 * bs * bs) + K + 8)


def step_bytes(B, bs, npl, window=0):
    """Bytes KB's in-place entry must move per call: each block's source
    and prediction read once, its levels and recon written once, its
    pick row and map entries, and (a cell launch) its local window read
    and written once."""
    return 4 * npl * B * (4 * bs * bs + 16 + 2 * window * window)


def pick_ops(B, bs, npl, K):
    """Operations of one pick call: 7 a predicted pixel and candidate."""
    return 7 * K * npl * B * bs * bs


def plan_grid(width: int, height: int) -> tuple:
    """(R, C): the partition plan's 32-pixel cells of a frame (its mi
    area, 8-pixel aligned, rounded up to whole cells)."""
    pw = (width + 7) // 8 * 8
    ph = (height + 7) // 8 * 8
    return (ph + 31) // 32, (pw + 31) // 32


def diagonal_sizes(R: int, C: int) -> list:
    """Cells of each anti-diagonal of an R x C grid, in wavefront order."""
    return [min(d, R - 1) - max(0, d - (C - 1)) + 1
            for d in range(R + C - 1)]


def key_launches(width: int, height: int) -> dict:
    """Launches of an untiled KEY frame on the partition path: per
    diagonal of the luma and of the chroma wavefront five KA picks and
    five KB steps; three KC."""
    R, C = plan_grid(width, height)
    steps = 2 * (R + C - 1)
    return {"steps": steps, "KA": 5 * steps, "KB": 5 * steps,
            "KC": KC_LAUNCHES, "total": 10 * steps + KC_LAUNCHES}


def ka_frame_bound_s(width: int, height: int) -> float:
    """The least time KA's picks of one untiled KEY frame need: the sum,
    over every pick call of both wavefronts, of ``bound``."""
    R, C = plan_grid(width, height)
    total_ms = 0.0
    for B in diagonal_sizes(R, C):
        for _, bs, npl, K, calls in PICKS:
            b = bound(pick_bytes(B, bs, npl, K), pick_ops(B, bs, npl, K))
            total_ms += calls * b["bound_ms"]
    return total_ms / 1e3
