"""The card's idle share of the traced window on a block: 100 x (1 - the
union of its kernel, copy and set intervals over the window's wall)."""


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
