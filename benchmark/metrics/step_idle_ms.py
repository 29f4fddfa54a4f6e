"""step_idle_ms: the mean over the window's denoise steps of the device's
idle milliseconds inside each step's program span (`magi/step`, from
`ArdfSampler.timed_step`): the host's planning, staging and launch before
the step's work reaches the card, and its wait for the card after."""

from benchmark import spans


def read(r):
    return spans.mean_idle_ms(r.trace, "magi/step")
