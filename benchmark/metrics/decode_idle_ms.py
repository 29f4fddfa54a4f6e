"""decode_idle_ms: the mean over the window's VAE decodes of the device's
idle milliseconds inside each decode's program span (`magi/decode`, from
`video_process.decode_chunk`): the card waiting on the decode's host work."""

from benchmark import spans


def read(r):
    return spans.mean_idle_ms(r.trace, "magi/decode")
