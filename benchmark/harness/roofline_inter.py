"""The least time the random-access cell's inter and temporal-filter
kernels need, counted from a frame's size and a chunk's GOP structure
(blocks, candidates, span lengths), never from the launches the program
made: the same work reads the same bound whatever kernels implement it.

The bytes and operations of each stage are copies of ``chip_smoke.py``'s
bounds (phase 3b: KD ``mc_8tap``, KE ``fullpel_search``, KF
``cdef_frame``, KB's batched ``txq_recon_skip``; phase 3e: KJ's SAD search
and KK's ``tf_span_filter``), written as arithmetic on the shapes: each
input read once and each output written once, int32 planes and blocks
(uint8 for KK's output, bool for KF's skip map), and the smoke's
operation counts. ``roofline.bound`` turns bytes and operations into
time. ``test_bench_roofline_inter.py`` holds each count equal to the
smoke's expression on the tensors the plain versions take and return.

An inter frame (``encoder/tpu_inter.plan_inter_frame``, then the frame's
CDEF) on its luma padded to R x C cells of 32 (B = 4RC blocks of 16, RC
of 32):

- the full-pel search: 8x8 blocks of the half-resolution plane, then
  16x16 blocks around twice their vectors (radius 16: 33 x 33 offsets);
- the subpel work at 16x16: two 9-candidate refinements of the searched
  vectors and two of the dominant vector, the searched and zero vectors
  scored (2), the dominant one scored (1), the three filter families
  predicted and scored (3); at 32x32 the four sub-vectors and zero (5),
  predicted and scored;
- the transforms: luma 16x16 (B) and 32x32 (RC), each chroma plane 8x8
  (B) and 16x16 (RC), each predicted once at its block size first;
- the CDEF frame pass (the search and three planes with the sources'
  errors) where the frame's quantizer-derived strengths are not all zero.

A span of the temporal filter over n frames of H x W: for each non-centre
frame the full-pel SAD search of every block of the 32-pixel grid (its
shape groups: full blocks, the partial bottom row, right column and
corner) over a window of 33 x 33 offsets; then the span's weighting and
accumulation over every pixel of the three planes.
"""
from __future__ import annotations

from .roofline import bound, txq_ops

SEARCH_RAD = 16                       # KE's and KJ's full-pel radius
OFFSETS = (2 * SEARCH_RAD + 1) ** 2   # candidates of one full-pel search
TAPS = 16 * 8                         # one candidate's filter taps (int32)
TF_BLOCK = 32                         # the temporal filter's block grid
KEY_SPAN = 3                          # a KEY and its two look-ahead frames

# the kernels whose device time each share divides
INTER_KERNELS = ("ke_strip_kernel", "kd_kernel", "kb_batch_kernel",
                 "kf_tile_kernel")
TF_KERNELS = ("kj_kernel", "kk_span_kernel")


# ---------------------------------------------------------------------------
# one call of each stage (phase 3b / 3e of chip_smoke.py)
# ---------------------------------------------------------------------------
def kd_bytes(plane_px: int, B: int, bw: int, K: int, src: bool = True,
             pred: bool = False) -> int:
    """KD: the reference plane, the block origins, the candidates' MVs and
    taps read once; the source blocks read once where given; the
    predictions (where wanted) and each candidate's SAD and SSE (where
    there are sources) written once."""
    n = plane_px + 2 * B + 2 * K * B + K * TAPS
    if src:
        n += B * bw * bw + 2 * K * B
    if pred:
        n += K * B * bw * bw
    return 4 * n


def kd_ops(B: int, bw: int, K: int) -> int:
    """8 + 8 taps of 2 operations and 3 for the SAD per pixel and
    candidate."""
    return 35 * K * B * bw * bw


def ke_bytes(plane_px: int, B: int, bw: int, centres: bool) -> int:
    """KE: the source blocks, the plane, the origins (and the centres)
    read once; the two offsets of each block written once."""
    return 4 * (B * bw * bw + plane_px + 2 * B + 2 * B * centres + 2 * B)


def ke_ops(B: int, bw: int) -> int:
    """33 x 33 offsets, 3 operations per pixel of each SSD."""
    return 3 * OFFSETS * B * bw * bw


def kb_bytes(B: int, bs: int) -> int:
    """KB's batched entry: the source and prediction blocks, the scan,
    the lambdas and the two rate tables (16 level costs and the
    2 log2(bs) + 1 eob costs) read once; the levels, eobs, recon, SSEs
    and coefficient rates written once."""
    eob_costs = 2 * (bs.bit_length() - 1) + 1
    return 4 * (4 * B * bs * bs + 4 * B + bs * bs + 16 + eob_costs)


def kf_bytes(mh: int, mw: int, ph: int, pw: int) -> int:
    """KF's frame pass over three planes (luma ph x pw, chroma halved):
    the planes and the sources read once, the filtered planes written
    once, the 8x8 blocks' skip flags (bool) read and their directions and
    variances written once, the 2 x 3 int64 error sums written once; the
    mi area is mh x mw."""
    planes = ph * pw + 2 * (ph // 2) * (pw // 2)
    blocks = (mh // 8) * (mw // 8)
    return 3 * 4 * planes + blocks + 2 * 4 * blocks + 2 * 3 * 8


def kf_ops(mh: int, mw: int) -> int:
    """12 taps of ~11 operations per filtered pixel and the search's ~16
    per luma pixel."""
    return 150 * (mh * mw * 3 // 2) + 16 * mh * mw


def kj_bytes(B: int, h: int, w: int) -> int:
    """KJ: the blocks and their windows (h + 32) x (w + 32) read once;
    each block's MV and SAD written once."""
    win = (h + 2 * SEARCH_RAD) * (w + 2 * SEARCH_RAD)
    return 4 * (B * h * w + B * win + 3 * B)


def kj_ops(B: int, h: int, w: int) -> int:
    """33 x 33 offsets, 3 operations (difference, absolute value, add)
    per pixel of each SAD."""
    return 3 * OFFSETS * B * h * w


def kk_bytes(n: int, H: int, W: int, B: int) -> int:
    """KK: the span's n frames of three int32 planes and their (n, B, 2)
    MVs read once; the three filtered uint8 planes written once."""
    px = H * W + 2 * (H // 2) * (W // 2)
    return 4 * n * px + 4 * n * B * 2 + px


def kk_ops(n: int, H: int, W: int) -> tuple:
    """(integer, float64) operations: per pixel and non-centre frame ~20
    integer (the difference and square, the window adds, the chroma's
    luma adds, the accumulation) and 11 float64; 5 a pixel to round."""
    px = H * W + 2 * (H // 2) * (W // 2)
    k = n - 1
    return (20 * k + 5) * px, 11 * k * px


# ---------------------------------------------------------------------------
# frames and chunks
# ---------------------------------------------------------------------------
def _ms(n_bytes, ops, fp64_ops=0) -> float:
    return bound(n_bytes, ops, fp64_ops)["bound_ms"]


def padded(width: int, height: int) -> tuple:
    """(mi_rows, mi_cols, ph, pw): a frame's mi grid and its luma padded
    to whole cells of 32."""
    mi_rows, mi_cols = (height + 7) // 8 * 2, (width + 7) // 8 * 2
    ph = (mi_rows * 4 + 31) // 32 * 32
    pw = (mi_cols * 4 + 31) // 32 * 32
    return mi_rows, mi_cols, ph, pw


def cdef_on(q: int) -> bool:
    """Whether a frame at base_q_idx ``q`` filters with CDEF: its
    quantizer-derived strengths (``tpu_frame.cdef_fixed_strengths``: luma
    primary ``clip((q - 16) // 48, 0, 8)``, secondary 1 from q 80, chroma
    primary one less) are not all zero."""
    return min(max((q - 16) // 48, 0), 8) > 0 or q >= 80


def cdef_bound_s(width: int, height: int) -> float:
    """The least time of one frame's CDEF pass."""
    mi_rows, mi_cols, ph, pw = padded(width, height)
    mh, mw = 4 * mi_rows, 4 * mi_cols
    return _ms(kf_bytes(mh, mw, ph, pw), kf_ops(mh, mw)) / 1e3


def inter_plan_bound_s(width: int, height: int) -> float:
    """The least time of one inter frame's plan: the sum of every stage's
    bound (the module docstring lists them)."""
    _, _, ph, pw = padded(width, height)
    R, C = ph // 32, pw // 32
    B, Bc = 4 * R * C, R * C
    luma, half = ph * pw, (ph // 2) * (pw // 2)
    ms = _ms(ke_bytes(half, B, 8, False), ke_ops(B, 8))
    ms += _ms(ke_bytes(luma, B, 16, True), ke_ops(B, 16))
    for K, pred, n in ((9, False, 4), (2, False, 1), (1, False, 1),
                       (3, True, 1)):
        ms += n * _ms(kd_bytes(luma, B, 16, K, True, pred), kd_ops(B, 16, K))
    ms += _ms(kd_bytes(luma, Bc, 32, 5, True, True), kd_ops(Bc, 32, 5))
    ms += 2 * _ms(kd_bytes(half, B, 8, 1, False, True), kd_ops(B, 8, 1))
    ms += 2 * _ms(kd_bytes(half, Bc, 16, 1, False, True), kd_ops(Bc, 16, 1))
    for n_blocks, bs, planes in ((B, 16, 1), (Bc, 32, 1), (B, 8, 2),
                                 (Bc, 16, 2)):
        ms += planes * _ms(kb_bytes(n_blocks, bs), txq_ops(n_blocks, bs))
    return ms / 1e3


def tf_groups(width: int, height: int) -> list:
    """[(h, w, blocks)]: the temporal filter's 32-pixel grid by block
    shape (a partial bottom row, right column and corner at sizes not a
    multiple of 32)."""
    rows = [(TF_BLOCK, height // TF_BLOCK)] + \
        ([(height % TF_BLOCK, 1)] if height % TF_BLOCK else [])
    cols = [(TF_BLOCK, width // TF_BLOCK)] + \
        ([(width % TF_BLOCK, 1)] if width % TF_BLOCK else [])
    return [(h, w, nr * nc) for h, nr in rows for w, nc in cols if nr * nc]


def tf_span_bound_s(n: int, width: int, height: int) -> float:
    """The least time of one span of n frames: KJ's search of each
    non-centre frame, KK over the span."""
    groups = tf_groups(width, height)
    B = sum(b for _, _, b in groups)
    ms = (n - 1) * sum(_ms(kj_bytes(b, h, w), kj_ops(b, h, w))
                       for h, w, b in groups)
    ms += _ms(kk_bytes(n, height, width, B), *kk_ops(n, height, width))
    return ms / 1e3


def arf_spans(frames: int, group: int) -> list:
    """Frames of each ARF's filter span in a chunk of ``frames`` frames
    (``encode_video_arf``): the group-end frame with up to two frames on
    each side inside its group's start and the chunk's end."""
    out, s = [], 1
    while s < frames:
        e = min(s + group, frames)
        centre = e - 1
        out.append(min(frames, centre + 3) - max(s, centre - 2))
        s = e
    return out


def key_span(frames: int) -> int:
    """Frames of the KEY's filter span (``filter_key_frame``)."""
    return min(KEY_SPAN, frames)
