"""Displayed frames the window completed over the window's wall time
(first submit to last completion, after a synchronize)."""


def read(run):
    return run.displayed / run.window_s if run.displayed else None
