"""The P-frame symbol walk of the port's ``encoder/tpu_interframe.py``: the
native walk (``script_ops``, ``native/ec.cpp`` ``ec_inter_script_walk``)
against its plain version (``script_ops_plain``, the Python walk over
``normative/mvref.find_mv_refs``) on synthetic inter plans drawn from a seed.

Each case holds the two ops arrays equal element for element and both
block counts equal to the plan's: 64-aligned frames, frames with partial
superblocks and edge partitions, monochrome, all-skip, all-split, no split
(but the edge's implied splits), and MV fields with large MVs and odd
(eighth-pel) ones. Together the cases write every MV class and all four
modes (NEAREST, NEAR, GLOBAL, NEW). Both ops arrays, played into the native
coder on copies of one set of CDFs, give equal bytes and equally adapted
CDFs. A frame header outside the walk's slice raises, through
``check_walk_slice`` and through a whole encode.
Tolerance: exact equality."""
import numpy as np
import pytest

from aom_av1_psy_tpu_torch.ec.context import FrameContext
from aom_av1_psy_tpu_torch.encoder import tpu_interframe as TIF
from aom_av1_psy_tpu_torch.encoder.frame import EncoderConfig
from aom_av1_psy_tpu_torch.normative import mvref as MR
from aom_av1_psy_tpu_torch.normative import tables
from aom_av1_psy_tpu_torch.normative.enums import TxSize
from aom_av1_psy_tpu_torch.utils.testframes import make_frame, make_gop


def mi_dims(w, h):
    return (h + 7) // 8 * 2, (w + 7) // 8 * 2


def plan_blocks(split, mi_rows, mi_cols) -> int:
    """The blocks a plan codes: each 32x32 cell inside the frame is one
    block, or, split, its 16x16 quarters inside the frame."""
    Rc, Cc = split.shape
    r = 8 * np.arange(Rc)[:, None]
    c = 8 * np.arange(Cc)[None, :]
    inside = (r < mi_rows) & (c < mi_cols)
    quarters = sum(((r + 4 * qr < mi_rows) & (c + 4 * qc < mi_cols))
                   .astype(int) for qr in (0, 1) for qc in (0, 1))
    return int(np.where(inside, np.where(split.astype(bool), quarters, 1),
                        0).sum())


def _levels(rng, eob, n, tx, big):
    """Levels of blocks with the eobs ``eob``: random values in scan order
    before each eob, a nonzero last one, zeros after (a few large ones to
    reach the Golomb tail where ``big``)."""
    scan = np.asarray(tables.scan_table(int(tx), 0))
    e = eob.reshape(-1)
    B = e.size
    vals = rng.integers(-3, 4, (B, n)) * (rng.random((B, n)) < 0.6)
    if big:
        vals = np.where(rng.random((B, n)) < 0.02, vals * 40, vals)
    vals = np.where(np.arange(n)[None, :] < e[:, None], vals, 0)
    last = rng.choice([-2, -1, 1, 3], B)
    rows = np.nonzero(e > 0)[0]
    vals[rows, e[rows] - 1] = last[rows]
    out = np.zeros((B, n), np.int32)
    out[:, scan] = vals
    return out.reshape(eob.shape + (n,))


def _eobs(rng, shape, n, skip_p):
    e = rng.integers(1, min(n, 48) + 1, shape)
    return np.where(rng.random(shape) < skip_p, 0, e).astype(np.int32)


def _mvs(rng, R2, C2, kind):
    """(R2, C2, 2) MVs in 1/8 pel: a few shared motions (so neighbours
    match), zeros, fresh ones; ``large`` adds MVs up to +-16380 (every MV
    class), ``odd`` eighth-pel ones."""
    palette = rng.integers(-40, 41, (5, 2)) * 2
    mv = palette[rng.integers(0, 5, (R2, C2))]
    fresh = rng.integers(-300, 301, (R2, C2, 2)) * 2
    mv = np.where(rng.random((R2, C2, 1)) < 0.25, fresh, mv)
    mv = np.where(rng.random((R2, C2, 1)) < 0.15, 0, mv)
    if kind == "large":
        big = rng.integers(-8190, 8191, (R2, C2, 2)) * 2
        mv = np.where(rng.random((R2, C2, 1)) < 0.3, big, mv)
    if kind == "odd":
        mv = mv + (rng.random((R2, C2, 2)) < 0.3)
    return mv.astype(np.int32)


def synthetic_plan(w, h, seed, nplanes=3, split="random", skip_p=0.3,
                   mv="mixed"):
    """An inter plan's host arrays (``tpu_inter.plan_inter_frame``'s keys
    and shapes) for a w x h frame, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    mi_rows, mi_cols = mi_dims(w, h)
    Rc, Cc = -(-mi_rows * 4 // 32), -(-mi_cols * 4 // 32)
    R2, C2 = 2 * Rc, 2 * Cc
    r = 8 * np.arange(Rc)[:, None]
    c = 8 * np.arange(Cc)[None, :]
    forced = (r + 4 >= mi_rows) | (c + 4 >= mi_cols)   # implied at the edge
    chosen = {"random": rng.random((Rc, Cc)) < 0.5,
              "all": np.ones((Rc, Cc), bool),
              "none": np.zeros((Rc, Cc), bool)}[split]
    plan = {"split32": (chosen | forced).astype(np.uint8),
            "mv8": _mvs(rng, R2, C2, mv)}
    tx32, tx16, tx8 = TxSize.TX_32X32, TxSize.TX_16X16, TxSize.TX_8X8
    big = mv == "large"
    plan["y_eob32"] = _eobs(rng, (Rc, Cc), 1024, skip_p)
    plan["y_eob16"] = _eobs(rng, (R2, C2), 256, skip_p)
    plan["y_levels32"] = _levels(rng, plan["y_eob32"], 1024, tx32, big)
    plan["y_levels16"] = _levels(rng, plan["y_eob16"], 256, tx16, big)
    if nplanes > 1:
        plan["uv_eob16"] = _eobs(rng, (2, Rc, Cc), 256, skip_p)
        plan["uv_eob8"] = _eobs(rng, (2, R2, C2), 64, skip_p)
        plan["uv_levels16"] = _levels(rng, plan["uv_eob16"], 256, tx16, big)
        plan["uv_levels8"] = _levels(rng, plan["uv_eob8"], 64, tx8, big)
    return plan, mi_rows, mi_cols


def walks(w, h, seed, nplanes=3, **kw):
    plan, mi_rows, mi_cols = synthetic_plan(w, h, seed, nplanes, **kw)
    inp = TIF.script_inputs(plan, nplanes)
    native = TIF.script_ops(inp, mi_rows, mi_cols, nplanes)
    plain = TIF.script_ops_plain(inp, mi_rows, mi_cols, nplanes)
    return plan, mi_rows, mi_cols, inp, native, plain


# (w, h, seed, nplanes, keyword arguments of synthetic_plan)
CASES = {
    "aligned-128x64": (128, 64, 1, 3, {}),
    "aligned-256x192": (256, 192, 2, 3, {}),
    "partial-200x120": (200, 120, 3, 3, {}),
    "partial-352x288": (352, 288, 4, 3, {}),
    "partial-176x144": (176, 144, 5, 3, {}),
    "mono-200x120": (200, 120, 6, 1, {}),
    "mono-256x128": (256, 128, 7, 1, {"split": "all"}),
    "all-skip": (200, 136, 8, 3, {"skip_p": 1.0}),
    "all-split": (352, 288, 9, 3, {"split": "all"}),
    "no-split": (352, 288, 10, 3, {"split": "none"}),
    "large-mvs": (320, 240, 11, 3, {"mv": "large"}),
    "large-mvs-edges": (200, 120, 12, 3, {"mv": "large", "split": "all"}),
    "odd-mvs": (256, 160, 13, 3, {"mv": "odd"}),
    "no-skip": (192, 104, 14, 3, {"skip_p": 0.0}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_native_walk_equals_plain(case):
    w, h, seed, nplanes, kw = CASES[case]
    plan, mi_rows, mi_cols, _, (ops, blocks), (ops_p, blocks_p) = walks(
        w, h, seed, nplanes, **kw)
    assert ops.dtype == np.int32 and ops.shape[1] == 5
    assert ops.shape == ops_p.shape
    np.testing.assert_array_equal(ops, ops_p)
    assert blocks == blocks_p == plan_blocks(plan["split32"], mi_rows,
                                             mi_cols)
    if kw.get("skip_p") == 1.0:
        assert not (ops[:, 0] == 2).any()      # no transform block coded


def _modes_and_classes(ops):
    """The modes the ops code (from the NEWMV / ZEROMV / REFMV symbols)
    and the MV classes of their components."""
    modes = set()
    for o in ops:
        if o[0] != 0:
            continue
        cdf, sym = o[1], o[3]
        if cdf == TIF.CDF_NEWMV and sym == 0:
            modes.add(MR.NEWMV)
        elif cdf == TIF.CDF_ZEROMV and sym == 0:
            modes.add(MR.GLOBALMV)
        elif cdf == TIF.CDF_REFMV:
            modes.add(MR.NEARMV if sym else MR.NEARESTMV)
    classes = ops[(ops[:, 0] == 0) & np.isin(
        ops[:, 1], (TIF.CDF_COMP0 + 1, TIF.CDF_COMP0 + 9)), 3]
    return modes, set(classes.tolist())


def test_cases_write_every_mode_and_mv_class():
    modes, classes = set(), set()
    for case in ("large-mvs", "large-mvs-edges", "partial-352x288"):
        w, h, seed, nplanes, kw = CASES[case]
        ops = walks(w, h, seed, nplanes, **kw)[4][0]
        m, c = _modes_and_classes(ops)
        modes |= m
        classes |= c
    assert modes == {MR.NEARESTMV, MR.NEARMV, MR.GLOBALMV, MR.NEWMV}
    assert classes == set(range(TIF.MV_CLASSES))


@pytest.mark.parametrize("case", ["partial-352x288", "large-mvs-edges"])
def test_native_and_plain_ops_code_to_equal_bytes(case):
    w, h, seed, nplanes, kw = CASES[case]
    _, _, _, inp, (ops, _), (ops_p, _) = walks(w, h, seed, nplanes, **kw)
    fc0 = FrameContext(110)
    out, adapted = [], []
    for o in (ops, ops_p):
        fc = fc0.copy()
        cdfs, bundles = TIF.script_tables(fc)
        out.append(TIF.code_script(o, cdfs, bundles, inp["levels"], fc,
                                   True))
        adapted.append([t.copy() for t in cdfs])
    assert len(out[0]) > 100 and out[0] == out[1]
    for a, b in zip(*adapted):
        np.testing.assert_array_equal(a, b)


def _headers():
    enc = TIF.GpuInterFrameEncoder(make_frame(64, 64, seed=1),
                                   EncoderConfig(base_q_idx=110), None, [],
                                   64, 64, device="cpu")
    return enc.make_headers()[1]


def _translation():
    gm = [MR.WarpModel() for _ in range(8)]
    gm[MR.LAST_FRAME].wmtype = MR.TRANSLATION
    return gm


OUTSIDE = {
    "tiles": lambda fh: setattr(fh.tiles, "tile_cols_log2", 1),
    "reference_select": lambda fh: setattr(fh, "reference_select", True),
    "skip_mode_present": lambda fh: setattr(fh, "skip_mode_present", True),
    "global_motion": lambda fh: setattr(fh, "global_motion", _translation()),
    "allow_ref_frame_mvs": lambda fh: setattr(fh, "allow_ref_frame_mvs",
                                              True),
    "allow_high_precision_mv": lambda fh: setattr(
        fh, "allow_high_precision_mv", True),
    "force_integer_mv": lambda fh: setattr(fh, "force_integer_mv", True),
    "is_filter_switchable": lambda fh: setattr(fh, "is_filter_switchable",
                                               True),
    "is_motion_mode_switchable": lambda fh: setattr(
        fh, "is_motion_mode_switchable", True),
}


@pytest.mark.parametrize("field", list(OUTSIDE))
def test_header_outside_the_slice_raises(field):
    fh = _headers()
    TIF.check_walk_slice(fh)                  # the encoder's own header
    OUTSIDE[field](fh)
    with pytest.raises(NotImplementedError, match=field):
        TIF.check_walk_slice(fh)


def test_encode_outside_the_slice_raises(monkeypatch):
    make = TIF.GpuInterFrameEncoder.make_headers

    def high_precision(self):
        seq, fh = make(self)
        fh.allow_high_precision_mv = True
        return seq, fh

    monkeypatch.setattr(TIF.GpuInterFrameEncoder, "make_headers",
                        high_precision)
    with pytest.raises(NotImplementedError, match="allow_high_precision_mv"):
        TIF.encode_video(make_gop(64, 64, 2), EncoderConfig(base_q_idx=150),
                         device="cpu")
