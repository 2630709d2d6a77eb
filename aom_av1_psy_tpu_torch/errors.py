"""Typed decode error surface (the aom_codec_err_t contract).

The reference maps every internal decode failure to a small set of error
codes through ``aom_internal_error`` (aom/internal/aom_codec_internal.h:368,
codes in aom/aom_codec.h) and guarantees that invalid input produces
AOM_CODEC_CORRUPT_FRAME / AOM_CODEC_UNSUP_BITSTREAM rather than a crash
(contract exercised by test/invalid_file_test.cc). This module is the
Pythonic equivalent: public decode entry points raise only ``Av1Error``
subclasses on bad input, never arbitrary internal exceptions.
"""
from __future__ import annotations


class Av1Error(Exception):
    """Base for all codec errors (aom_codec_err_t analogue)."""

    code = "AOM_CODEC_ERROR"


class Av1CorruptFrameError(Av1Error):
    """The stream is malformed or internally inconsistent
    (AOM_CODEC_CORRUPT_FRAME)."""

    code = "AOM_CODEC_CORRUPT_FRAME"


class Av1UnsupportedBitstreamError(Av1Error):
    """Legal AV1 the decoder does not (yet) implement
    (AOM_CODEC_UNSUP_BITSTREAM)."""

    code = "AOM_CODEC_UNSUP_BITSTREAM"


class Av1InvalidParamError(Av1Error):
    """Invalid API usage / parameter (AOM_CODEC_INVALID_PARAM)."""

    code = "AOM_CODEC_INVALID_PARAM"


def outside_the_port(tool: str) -> NotImplementedError:
    """The error for a coding tool that no stream the port writes uses
    (loop restoration, superres, warped or non-translational global
    motion): the port's decoder leaves it out, and ``decode_packet``
    reports it as an ``Av1UnsupportedBitstreamError``."""
    return NotImplementedError(f"{tool}: left out of the port's decoder, "
                               "which reads the streams the port writes")
