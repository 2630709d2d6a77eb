#!/usr/bin/env python3
"""Generate ``aom_av1_psy_tpu_torch/csrc/kr_programs.cuh``: kernel KR's
1-D transform programs as straight-line register code, and the
compile-time plan of each tx size.

The butterfly structure of the 14 stage programs (``av1_{f,i}dct{4..64}``,
``av1_{f,i}adst{8,16}``) is normative data, already in the port as
``normative/data/txfm_stages.json``: per stage and output one entry
``[kind, a, b, wa, wb, clamp]``. ``op_lists`` reads each entry as one
operation on the stage's inputs:

  mov a      x[a]                       (kind 0, weights 1, 0, a == b)
  neg a      -x[a]                      (kind 0, weights -1, 0, a == b)
  add a b    x[a] + x[b]                (kind 0, weights 1, 1)
  sub a b    x[a] - x[b]                (kind 0, weights (1, -1) or, with
                                         a and b swapped, (-1, 1))
  btf a b    (x[a]*wa + x[b]*wb + 2^(cb-1)) >> cb   (kind 1; wa, wb the
             signed cospi index + 1 of the entry, resolved at cos bit cb)

each followed by the stage clamp where the entry carries it (the inverse
transforms' ``clamp_value(stage_range)``). Every product and sum wraps
to int32, as the reference's int32 arithmetic does, so ``x*1 + y*-1`` is
``x - y`` bit for bit. The header has one function template per program,
``kr_<program><CB, CLAMP>(int (&x)[N], lo, hi)``: a ``mov`` is a register
rename, the weights are compile-time constants of the cos bit
(``kr_cospi``), and the clamp is compiled in only where CLAMP is set.

``plan`` fixes, per tx size and direction, what ``csrc/txfm2d.cu`` needs
at compile time: the shifts, cos bits and rescale of the reference
(``ops/txfm_host``), the blocks a CTA holds (G) and its threads (T), and
the two shared-memory tiles' strides (padded for conflict-free access).

    python3 tools/gen_kr_programs.py           # rewrite the header
    python3 tools/gen_kr_programs.py --check   # exit 1 if it differs

The committed header must equal ``render()``
(``tests/test_torch_kr_programs.py``), so a plain nvcc build of the
repository's sources needs no generator.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from aom_av1_psy_tpu_torch.normative import tables  # noqa: E402
from aom_av1_psy_tpu_torch.normative.enums import (TX_HEIGHT,  # noqa: E402
                                                   TX_WIDTH)
from aom_av1_psy_tpu_torch.ops.txfm_host import (  # noqa: E402
    FWD_COS_BIT_COL, FWD_COS_BIT_ROW, FWD_SHIFT, INV_COS_BIT, INV_SHIFT,
    _stage_data)

HEADER = os.path.join(REPO, "aom_av1_psy_tpu_torch", "csrc",
                      "kr_programs.cuh")
PROGRAMS = ("av1_fdct4", "av1_fdct8", "av1_fdct16", "av1_fdct32",
            "av1_fdct64", "av1_fadst8", "av1_fadst16", "av1_idct4",
            "av1_idct8", "av1_idct16", "av1_idct32", "av1_idct64",
            "av1_iadst8", "av1_iadst16")
COS_BITS = (10, 11, 12, 13)     # forward 10-13, inverse 12
N_TX = 19
MAX_THREADS = 128
SMEM_LIMIT = 48 * 1024          # static shared memory of one CTA


# ----------------------------------------------------------------------
# the programs
# ----------------------------------------------------------------------
def op_lists(func: str) -> list:
    """The stages of ``func`` as operations (op, a, b, wa, wb, clamp), one
    per output in output order; wa, wb are the entry's signed cospi
    codes for ``btf`` and 0 otherwise."""
    stages = []
    for stage in _stage_data()[func]:
        ops = []
        for kind, a, b, wa, wb, cl in stage:
            cl = bool(cl)
            if kind == 1:
                ops.append(("btf", a, b, wa, wb, cl))
            elif (wa, wb) == (1, 0) and a == b:
                ops.append(("mov", a, a, 0, 0, cl))
            elif (wa, wb) == (-1, 0) and a == b:
                ops.append(("neg", a, a, 0, 0, cl))
            elif (wa, wb) == (1, 1):
                ops.append(("add", a, b, 0, 0, cl))
            elif (wa, wb) == (1, -1):
                ops.append(("sub", a, b, 0, 0, cl))
            elif (wa, wb) == (-1, 1):
                ops.append(("sub", b, a, 0, 0, cl))
            else:
                raise ValueError(f"{func}: entry {[kind, a, b, wa, wb, cl]}"
                                 " is not one of the operations")
        stages.append(ops)
    return stages


def _w32(v):
    return (v + 2**31) % 2**32 - 2**31


def _cos(code: int, cospi) -> int:
    return int(np.sign(code)) * int(cospi[abs(code) - 1])


def run_ops(x, func: str, cos_bit: int, clamp_bit=None):
    """``func``'s operations over (N, n) integer vectors in numpy, every
    result wrapped to int32; the stage clamp where an entry carries it and
    ``clamp_bit`` is given. Returns (N, n) int64 holding int32 values."""
    x = np.asarray(x, np.int64)
    cospi = tables.cospi(cos_bit)
    rnd = 1 << (cos_bit - 1)
    if clamp_bit is not None:
        lo, hi = -(1 << (clamp_bit - 1)), (1 << (clamp_bit - 1)) - 1
    for ops in op_lists(func):
        out = []
        for op, a, b, wa, wb, cl in ops:
            if op == "mov":
                v = x[:, a]
            elif op == "neg":
                v = _w32(-x[:, a])
            elif op == "add":
                v = _w32(x[:, a] + x[:, b])
            elif op == "sub":
                v = _w32(x[:, a] - x[:, b])
            else:
                v = _w32(_w32(x[:, a] * _cos(wa, cospi))
                         + _w32(x[:, b] * _cos(wb, cospi)))
                v = _w32(v + rnd) >> cos_bit
            if cl and clamp_bit is not None:
                v = np.clip(v, lo, hi)
            out.append(v)
        x = np.stack(out, axis=1)
    return x


def _emit_program(func: str) -> list:
    n = len(_stage_data()[func][0])
    lines = [f"template <int CB, bool CLAMP>",
             f"__device__ __forceinline__ void kr_{func[4:]}(int (&x)[{n}], "
             f"int lo, int hi) {{"]
    names = [f"x{i}" for i in range(n)]
    lines += [f"  const int {nm} = x[{i}];" for i, nm in enumerate(names)]
    tmp = 0
    for s, ops in enumerate(op_lists(func)):
        lines.append(f"  // stage {s + 1}")
        new = []
        for op, a, b, wa, wb, cl in ops:
            if op == "mov" and not cl:
                new.append(names[a])
                continue
            if op == "mov":
                expr = names[a]
            elif op == "neg":
                expr = f"sub32(0, {names[a]})"
            elif op in ("add", "sub"):
                expr = f"{op}32({names[a]}, {names[b]})"
            else:
                ca = f"{'-' if wa < 0 else ''}kr_cospi(CB, {abs(wa) - 1})"
                cb = f"{'-' if wb < 0 else ''}kr_cospi(CB, {abs(wb) - 1})"
                expr = f"kr_btf<CB, {ca}, {cb}>({names[a]}, {names[b]})"
            if cl:
                expr = f"kr_clamp<CLAMP>({expr}, lo, hi)"
            lines.append(f"  const int t{tmp} = {expr};")
            new.append(f"t{tmp}")
            tmp += 1
        names = new
    lines += [f"  x[{i}] = {nm};" for i, nm in enumerate(names)]
    lines.append("}")
    return lines


# ----------------------------------------------------------------------
# the plan of each tx size
# ----------------------------------------------------------------------
def _row_stride(n: int) -> int:
    """Words a tile row of n values takes: 16-byte aligned, and an odd
    number of 16-byte units from n = 8 up, so that 8 lanes reading 8 rows
    as int4 hit 8 distinct bank quads (n = 4: one unit)."""
    return 4 if n == 4 else n + 4


def _block_stride(rows: int, stride: int, cols: int) -> int:
    """Words a block's tile takes: ``rows`` rows of ``stride``, padded so
    that a warp's lanes on consecutive columns of consecutive blocks (cols
    < 32 a block) fall on distinct banks."""
    base = rows * stride
    return base + ((cols - base) % 32 if cols < 32 else 0)


def plan(ts: int, inverse: bool) -> dict:
    """The compile-time plan of one KR kernel instantiation.

    Tile A holds a block as [r][c] (H rows of W), tile B as [c][r]: the
    forward's coefficients (W rows of H), the inverse's input
    coefficients (the first CW = min(W, 32) rows of their first HR =
    min(H, 32) values: a 64-point size codes no coefficient beyond 31).
    The column pass has W vectors a block, the row pass HR (the forward:
    HR = H; the inverse's rows beyond 31 are zero and stay zero through
    its row pass, so its column pass takes them as 0). A CTA of G blocks
    has T = G * min(W, H) threads, so that each thread takes W / min and
    H / min vectors (1, 2 or 4) and none is idle in either pass, save in
    the 64x64 inverse's row pass: it has 32 coded rows for 64 threads a
    block, which keeps a thread a 64-point column in its column pass and
    twice the warps that G * min(W, HR) would have."""
    w, h = int(TX_WIDTH[ts]), int(TX_HEIGHT[ts])
    lw, lh = w.bit_length() - 3, h.bit_length() - 3
    hr = min(h, 32) if inverse else h
    cw = min(w, 32) if inverse else w
    ra = _row_stride(w)
    ba = _block_stride(h, ra, w)
    rb = _row_stride(hr)
    bb = _block_stride(cw, rb, hr)
    m = min(w, h)
    g = 1
    while 2 * g * m <= MAX_THREADS and 2 * g * (ba + bb) * 4 <= SMEM_LIMIT:
        g *= 2
    if inverse:
        cb1 = cb2 = INV_COS_BIT
        sh = [int(v) for v in INV_SHIFT[ts]] + [0]
    else:
        cb1, cb2 = int(FWD_COS_BIT_COL[lw][lh]), int(FWD_COS_BIT_ROW[lw][lh])
        sh = [int(v) for v in FWD_SHIFT[ts]]
    return {"W": w, "H": h, "HR": hr, "CW": cw, "CB1": cb1, "CB2": cb2,
            "SH0": sh[0], "SH1": sh[1], "SH2": sh[2],
            "RECT": int(abs(lw - lh) == 1), "G": g, "T": g * m,
            "RA": ra, "BA": ba, "RB": rb, "BB": bb}


PLAN_KEYS = ("W", "H", "HR", "CW", "CB1", "CB2", "SH0", "SH1", "SH2",
             "RECT", "G", "T", "RA", "BA", "RB", "BB")


# ----------------------------------------------------------------------
# the header
# ----------------------------------------------------------------------
def _table(rows) -> list:
    out = []
    for row in rows:
        vals = [str(int(v)) for v in row]
        line = "      {"
        for i, v in enumerate(vals):
            piece = v + (", " if i + 1 < len(vals) else "")
            if len(line) + len(piece) > 78:
                out.append(line.rstrip())
                line = "       "
            line += piece
        out.append(line + "},")
    return out


def render() -> str:
    lines = [
        "// Generated by tools/gen_kr_programs.py from",
        "// normative/data/txfm_stages.json and ops/txfm_host's tables; do "
        "not edit.",
        "// Regenerate: python3 tools/gen_kr_programs.py",
        "//",
        "// Kernel KR's 1-D stage programs as straight-line code over an "
        "int array",
        "// with compile-time indices (registers): a stage's pass-through "
        "is a",
        "// rename, +-1 entries an add or a subtract, a butterfly two "
        "products,",
        "// the rounding add and the shift; the stage clamp where the "
        "entry",
        "// carries it and CLAMP is set. int32 wraparound as the "
        "reference's.",
        "#pragma once",
        "",
        '#include "txfm.cuh"',
        "",
        "// cospi[i] at cos bit cb (10..13), sinpi[i] (i < 5)",
        "__host__ __device__ constexpr int kr_cospi(int cb, int i) {",
        f"  constexpr int t[{len(COS_BITS)}][64] = {{",
        *_table(tables.cospi(cb) for cb in COS_BITS),
        "  };",
        f"  return t[cb - {COS_BITS[0]}][i];",
        "}",
        "",
        "__host__ __device__ constexpr int kr_sinpi(int cb, int i) {",
        f"  constexpr int t[{len(COS_BITS)}][5] = {{",
        *_table(tables.sinpi(cb) for cb in COS_BITS),
        "  };",
        f"  return t[cb - {COS_BITS[0]}][i];",
        "}",
        "",
        "template <bool CLAMP>",
        "__device__ __forceinline__ int kr_clamp(int v, int lo, int hi) {",
        "  return CLAMP ? clampi(v, lo, hi) : v;",
        "}",
        "",
        "template <int CB, int WA, int WB>",
        "__device__ __forceinline__ int kr_btf(int a, int b) {",
        "  return add32(add32(mul32(a, WA), mul32(b, WB)), 1 << (CB - 1)) >>"
        " CB;",
        "}",
        "",
        "// The plan of each tx size (tools/gen_kr_programs.plan): W, H; "
        "HR the",
        "// row pass's vectors a block and CW the inverse's coded "
        "columns; the",
        "// two passes' cos bits; the shifts (forward three, inverse "
        "two);",
        "// RECT the NewSqrt2 rescale; G blocks and T threads a CTA; tile "
        "A",
        "// ([r][c]) row and block strides RA, BA, tile B ([c][r]) RB, BB "
        "(words).",
        "template <int TS, bool INV>",
        "struct KrPlan;",
    ]
    for inverse in (False, True):
        for ts in range(N_TX):
            p = plan(ts, inverse)
            body = ", ".join(f"{k} = {p[k]}" for k in PLAN_KEYS)
            lines.append(f"template <>")
            lines.append(f"struct KrPlan<{ts}, {str(inverse).lower()}> {{")
            line = "  static constexpr int "
            for i, piece in enumerate(body.split(", ")):
                piece += ";" if i + 1 == len(PLAN_KEYS) else ", "
                if len(line) + len(piece) > 79:
                    lines.append(line.rstrip())
                    line = "                       "
                line += piece
            lines += [line, "};"]
    for func in PROGRAMS:
        lines += [""] + _emit_program(func)
    return "\n".join(lines) + "\n"


def main() -> int:
    text = render()
    if "--check" in sys.argv[1:]:
        with open(HEADER) as f:
            same = f.read() == text
        print("up to date" if same else f"{HEADER} differs from render()")
        return 0 if same else 1
    with open(HEADER, "w") as f:
        f.write(text)
    print(f"wrote {HEADER} ({text.count(chr(10))} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
