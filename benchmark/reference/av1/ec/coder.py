"""Daala-derived multisymbol adaptive range coder ("od_ec").

Bit-exact reimplementation of the normative AV1 entropy coder semantics
(reference: ``aom_dsp/entenc.c`` encoder with 64-bit low window,
``aom_dsp/entdec.c`` decoder with 32-bit dif window, ``aom_dsp/prob.h``
``update_cdf``). Per-tile symbol streams are inherently serial; this module
is the host-side scalar engine. Throughput paths batch across tiles/frames
and use the C++ implementation in ``native/`` when built.

CDF convention ("icdf"): entry i stores 32768 - cdf(i); the last real symbol
entry is 0; one trailing slot holds the adaptation counter.
"""
from __future__ import annotations

import numpy as np

CDF_PROB_TOP = 1 << 15
EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1
_LOTS_OF_BITS = 0x4000


def update_cdf(cdf: np.ndarray, val: int, nsymbs: int) -> None:
    """Adapt an icdf in place after coding symbol ``val`` (prob.h:110-138)."""
    count = int(cdf[nsymbs])
    rate = 4 + (count >> 4) + (3 < nsymbs)
    for i in range(nsymbs - 1):
        if i < val:
            cdf[i] += (CDF_PROB_TOP - int(cdf[i])) >> rate
        else:
            cdf[i] -= int(cdf[i]) >> rate
    cdf[nsymbs] += count < 32


class Encoder:
    """od_ec range encoder (entenc.c)."""

    def __init__(self) -> None:
        self.allow_update = True  # frame-level disable_cdf_update gate
        self.buf = bytearray()
        self.low = 0  # 64-bit window
        self.rng = 0x8000
        self.cnt = -9

    # -- internals ---------------------------------------------------------
    def _carry(self, idx: int) -> None:
        while True:
            s = self.buf[idx] + 1
            self.buf[idx] = s & 0xFF
            if s < 256:
                return
            idx -= 1

    def _normalize(self, low: int, rng: int) -> None:
        d = 16 - rng.bit_length()
        s = self.cnt + d
        if s >= 40:  # flush whole bytes out of the 64-bit low window
            c = self.cnt
            nbr = (s >> 3) + 1
            c += 24 - (nbr << 3)
            output = low >> c
            low &= (1 << c) - 1
            mask = 1 << (nbr << 3)
            carry = output & mask
            output &= mask - 1
            pre = len(self.buf)
            self.buf += output.to_bytes(nbr, "big")
            if carry:
                self._carry(pre - 1)
            s = c + d - 24
        self.low = (low << d) & _M64
        self.rng = rng << d
        self.cnt = s

    # -- symbol coding -----------------------------------------------------
    def encode_q15(self, fl: int, fh: int, s: int, nsyms: int) -> None:
        l, r = self.low, self.rng
        n = nsyms - 1
        if fl < CDF_PROB_TOP:
            u = ((r >> 8) * (fl >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + \
                EC_MIN_PROB * (n - (s - 1))
            v = ((r >> 8) * (fh >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + \
                EC_MIN_PROB * (n - s)
            l = (l + r - u) & _M64
            r = u - v
        else:
            r -= ((r >> 8) * (fh >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + \
                 EC_MIN_PROB * (n - s)
        self._normalize(l, r)

    def encode_cdf(self, s: int, icdf, nsyms: int) -> None:
        fl = int(icdf[s - 1]) if s > 0 else CDF_PROB_TOP
        self.encode_q15(fl, int(icdf[s]), s, nsyms)

    def encode_symbol(self, s: int, icdf: np.ndarray, nsyms: int,
                      allow_update: bool | None = None) -> None:
        """aom_write_symbol: code with adaptation."""
        self.encode_cdf(s, icdf, nsyms)
        if self.allow_update if allow_update is None else allow_update:
            update_cdf(icdf, s, nsyms)

    def encode_bool_q15(self, val: int, f: int) -> None:
        l, r = self.low, self.rng
        v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        if val:
            l = (l + r - v) & _M64
            r = v
        else:
            r -= v
        self._normalize(l, r)

    def write_bit(self, bit: int) -> None:
        """aom_write_bit — raw bit at p=1/2 (bitwriter.h:79)."""
        p = (0x7FFFFF - (128 << 15) + 128) >> 8
        self.encode_bool_q15(bit, p)

    def write_literal(self, data: int, bits: int) -> None:
        for b in range(bits - 1, -1, -1):
            self.write_bit((data >> b) & 1)

    def tell(self) -> int:
        return self.cnt + 10 + len(self.buf) * 8

    def done(self) -> bytes:
        """Flush; returns the final byte string (entenc.c od_ec_enc_done)."""
        l = self.low
        c = self.cnt
        s = 10
        m = 0x3FFF
        e = ((l + m) & ~m) | (m + 1)
        s += c
        if s > 0:
            n = (1 << (c + 16)) - 1
            while s > 0:
                val = (e >> (c + 16)) & 0xFFFF
                self.buf.append(val & 0xFF)
                if val & 0x100:
                    self._carry(len(self.buf) - 2)
                e &= n
                s -= 8
                c -= 8
                n >>= 8
        return bytes(self.buf)


class Decoder:
    """od_ec range decoder (entdec.c, 32-bit dif window)."""

    WINDOW = 32

    def __init__(self, data: bytes) -> None:
        self.allow_update = True  # frame-level disable_cdf_update gate
        self.buf = data
        self.bptr = 0
        self.end = len(data)
        self.tell_offs = 10 - (self.WINDOW - 8)
        self.dif = (1 << (self.WINDOW - 1)) - 1
        self.rng = 0x8000
        self.cnt = -15
        self._refill()

    def _refill(self) -> None:
        s = self.WINDOW - 9 - (self.cnt + 15)
        dif, cnt, bptr = self.dif, self.cnt, self.bptr
        while s >= 0 and bptr < self.end:
            dif ^= self.buf[bptr] << s
            cnt += 8
            bptr += 1
            s -= 8
        if bptr >= self.end:
            self.tell_offs += _LOTS_OF_BITS - cnt
            cnt = _LOTS_OF_BITS
        self.dif, self.cnt, self.bptr = dif, cnt, bptr

    def _normalize(self, dif: int, rng: int, ret: int) -> int:
        d = 16 - rng.bit_length()
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & _M32
        self.rng = rng << d
        if self.cnt < 0:
            self._refill()
        return ret

    def decode_cdf(self, icdf, nsyms: int) -> int:
        dif, r = self.dif, self.rng
        n = nsyms - 1
        c = dif >> (self.WINDOW - 16)
        v = r
        ret = -1
        while True:
            u = v
            ret += 1
            v = ((r >> 8) * (int(icdf[ret]) >> EC_PROB_SHIFT) >>
                 (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (n - ret)
            if c >= v:
                break
        r = u - v
        dif -= v << (self.WINDOW - 16)
        return self._normalize(dif, r, ret)

    def decode_symbol(self, icdf: np.ndarray, nsyms: int,
                      allow_update: bool | None = None) -> int:
        ret = self.decode_cdf(icdf, nsyms)
        if self.allow_update if allow_update is None else allow_update:
            update_cdf(icdf, ret, nsyms)
        return ret

    def decode_bool_q15(self, f: int) -> int:
        dif, r = self.dif, self.rng
        v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        vw = v << (self.WINDOW - 16)
        ret = 1
        r_new = v
        if dif >= vw:
            r_new = r - v
            dif -= vw
            ret = 0
        return self._normalize(dif, r_new, ret)

    def read_bit(self) -> int:
        p = (0x7FFFFF - (128 << 15) + 128) >> 8
        return self.decode_bool_q15(p)

    def read_literal(self, bits: int) -> int:
        v = 0
        for b in range(bits - 1, -1, -1):
            v |= self.read_bit() << b
        return v

    def tell(self) -> int:
        return self.bptr * 8 - self.cnt + self.tell_offs
