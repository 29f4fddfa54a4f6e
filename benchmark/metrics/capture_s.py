"""capture_s: the host seconds the set-up's sampler spent warming and
capturing the walk's step variants (`ArdfSampler.capture_seconds`)."""


def read(r):
    return r.capture_seconds or None
