"""frames_per_s: video frames of denoising work finished in the window, per
second of it: frames a chunk x (chunk-steps done / steps a chunk) / window
seconds, the window from its open (the request's start, or the end of the
traffic's lead-in) to the end of its last step or decode, so every second
of it counts."""


def read(r):
    return r.frames_per_chunk * r.chunk_steps / r.num_steps / r.window_s
