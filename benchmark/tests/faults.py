"""Faults planted under a run, for the tests that see `correct` come out
false: each wraps the program's `transport._integrate_and_store` (a step's
Euler update written into the latent state), `transport._combine3` (the
three-branch CFG combination) or `post_chunk_process` (the decode), and
uses device ops alone, so a step captured as a CUDA graph captures the
fault."""

import torch


def unchanged(xs, x_chunk_den, velocity, dt, c_start, cw, n_den):
    """A step that returns its state unchanged."""


def _keep(orig, frames_of):
    """`orig`, with the frames `frames_of(dt, c_start, cw, n_den)` (a device
    index) put back as they were before the step."""
    def integrate(xs, x_chunk_den, velocity, dt, c_start, cw, n_den):
        idx = frames_of(dt, c_start, cw, n_den)
        before = xs.index_select(1, idx)
        orig(xs, x_chunk_den, velocity, dt, c_start, cw, n_den)
        xs.index_copy_(1, idx, before)
    return integrate


def half(orig):
    """A step that updates the first half of its chunks and leaves out the rest."""
    def frames(dt, c_start, cw, n_den):
        keep = max(1, n_den // 2)
        return c_start * cw + torch.arange(keep * cw, n_den * cw, device=dt.device)
    return _keep(orig, frames)


def one_chunk(orig):
    """A step of several chunks that leaves out the update of the one that
    moves least (the smallest dt)."""
    def frames(dt, c_start, cw, n_den):
        if n_den < 2:
            return torch.arange(0, device=dt.device)
        j = dt[:n_den].abs().argmin()
        return (c_start + j) * cw + torch.arange(cw, device=dt.device)
    return _keep(orig, frames)


def altered_velocity(orig):
    """An answer altered where it is produced: the velocity 1% too large."""
    def integrate(xs, x_chunk_den, velocity, dt, c_start, cw, n_den):
        orig(xs, x_chunk_den, velocity * 1.01, dt, c_start, cw, n_den)
    return integrate


def altered_frames(orig):
    """A decoded frame altered where it is produced."""
    def decode(chunk, config, device):
        frames = orig(chunk, config, device).copy()
        frames[0] = 255 - frames[0]
        return frames
    return decode


def dropped_text(orig):
    """A three-branch step that drops its text branch: the null-caption
    branch's output in place of the text one's in the combination
    (`transport._combine3`)."""
    def combine(xs, si, x_chunk, v1, v2, v3, n_den, extra, cw):
        orig(xs, si, x_chunk, v2, v2, v3, n_den, extra, cw)
    return combine
