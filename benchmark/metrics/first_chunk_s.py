"""first_chunk_s: seconds from the request's start (the window's, unless the
traffic has a lead-in) until its first chunk's frames are decoded and on
the host, however late."""


def read(r):
    return r.first_chunk_s
