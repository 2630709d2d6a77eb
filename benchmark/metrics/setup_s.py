"""Seconds from process start to the first timed frame's submit: torch's
import, the CUDA context, loading (or, in a fresh checkout, building) the
program's libraries, making the content from the seed, the warm-up."""


def read(run):
    return run.setup_s
