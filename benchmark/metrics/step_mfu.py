"""step_mfu: the window's denoise steps' share of the chip's peak (%): the
work of every step, counted from the config (`benchmark.work`), each kind at
the peak of the precision it runs in, over the steps' host seconds."""


def read(r):
    wall = sum(s for _, s in r.steps)
    if not wall:
        return None
    return 100.0 * sum(op.peak_s for op in r.ops()) / wall
