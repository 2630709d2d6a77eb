"""MSB-first bit reader/writer for uncompressed headers, plus leb128/uvlc.

Mirrors the reference's aom_read_bit_buffer / aom_write_bit_buffer and
aom_uleb_* (aom_dsp/bitreader_buffer.c, aom/src/aom_integer.c).
"""
from __future__ import annotations


class BitWriter:
    def __init__(self) -> None:
        self.buf = bytearray()
        self.bit_off = 0  # bits written into current byte

    def f(self, value: int, bits: int) -> None:
        """Write fixed-width unsigned value, MSB first."""
        for i in range(bits - 1, -1, -1):
            bit = (value >> i) & 1
            if self.bit_off == 0:
                self.buf.append(0)
            self.buf[-1] |= bit << (7 - self.bit_off)
            self.bit_off = (self.bit_off + 1) & 7

    def su(self, value: int, bits: int) -> None:
        """Signed value: magnitude bits then handled as two's complement
        (spec su(n): value in [-(2^(n-1)), 2^(n-1)-1] coded as n bits)."""
        self.f(value & ((1 << bits) - 1), bits)

    def uvlc(self, value: int) -> None:
        v = value + 1
        n = v.bit_length()
        self.f(0, n - 1)
        self.f(v, n)

    def byte_align(self) -> None:
        if self.bit_off:
            self.bit_off = 0

    def trailing_bits(self) -> None:
        """trailing_one_bit + zero pad to byte boundary."""
        self.f(1, 1)
        self.byte_align()

    def data(self) -> bytes:
        return bytes(self.buf)


class BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0  # bit position

    def f(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def su(self, bits: int) -> int:
        v = self.f(bits)
        if v >= 1 << (bits - 1):
            v -= 1 << bits
        return v

    def uvlc(self) -> int:
        n = 0
        while self.f(1) == 0:
            n += 1
            if n > 32:
                raise ValueError("uvlc too long")
        if n == 0:
            return 0
        return self.f(n) + (1 << n) - 1

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def byte_offset(self) -> int:
        return (self.pos + 7) >> 3


def write_leb128(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def read_leb128(data: bytes, pos: int) -> tuple[int, int]:
    """Returns (value, new_pos)."""
    v = 0
    for i in range(8):
        byte = data[pos + i]
        v |= (byte & 0x7F) << (7 * i)
        if not byte & 0x80:
            return v, pos + i + 1
    raise ValueError("leb128 too long")
