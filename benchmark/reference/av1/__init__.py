"""A frozen numpy AV1 decoder: ``decoder.obu.Av1Decoder`` decodes a
stream packet by packet; its reference slots hold every decoded frame."""
