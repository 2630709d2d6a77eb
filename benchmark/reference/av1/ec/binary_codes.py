"""Finite subexponential / quasi-uniform side codes
(aom_dsp/binary_codes_{reader,writer}.c, recenter.h) over the range coder's
raw-bit channel. Used by loop-restoration parameter coding."""
from __future__ import annotations

from .coder import Encoder, Decoder


def _inv_recenter_nonneg(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    if (v & 1) == 0:
        return (v >> 1) + r
    return r - ((v + 1) >> 1)


def _recenter_nonneg(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    if v >= r:
        return (v - r) << 1
    return ((r - v) << 1) - 1


def inv_recenter_finite_nonneg(n: int, r: int, v: int) -> int:
    if (r << 1) <= n:
        return _inv_recenter_nonneg(r, v)
    return n - 1 - _inv_recenter_nonneg(n - 1 - r, v)


def recenter_finite_nonneg(n: int, r: int, v: int) -> int:
    if (r << 1) <= n:
        return _recenter_nonneg(r, v)
    return _recenter_nonneg(n - 1 - r, n - 1 - v)


def read_primitive_quniform(dec: Decoder, n: int) -> int:
    if n <= 1:
        return 0
    l = n.bit_length()
    m = (1 << l) - n
    v = dec.read_literal(l - 1)
    return v if v < m else (v << 1) - m + dec.read_bit()


def write_primitive_quniform(enc: Encoder, n: int, v: int) -> None:
    if n <= 1:
        return
    l = n.bit_length()
    m = (1 << l) - n
    if v < m:
        enc.write_literal(v, l - 1)
    else:
        enc.write_literal(m + ((v - m) >> 1), l - 1)
        enc.write_bit((v - m) & 1)


def read_primitive_subexpfin(dec: Decoder, n: int, k: int) -> int:
    i = 0
    mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            return read_primitive_quniform(dec, n - mk) + mk
        if not dec.read_bit():
            return dec.read_literal(b) + mk
        i += 1
        mk += a


def write_primitive_subexpfin(enc: Encoder, n: int, k: int, v: int) -> None:
    i = 0
    mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            write_primitive_quniform(enc, n - mk, v - mk)
            return
        if v >= mk + a:
            enc.write_bit(1)
            i += 1
            mk += a
        else:
            enc.write_bit(0)
            enc.write_literal(v - mk, b)
            return


def read_primitive_refsubexpfin(dec: Decoder, n: int, k: int, ref: int) -> int:
    return inv_recenter_finite_nonneg(n, ref,
                                      read_primitive_subexpfin(dec, n, k))


def write_primitive_refsubexpfin(enc: Encoder, n: int, k: int, ref: int,
                                 v: int) -> None:
    write_primitive_subexpfin(enc, n, k, recenter_finite_nonneg(n, ref, v))
