"""decode_ms: the mean host milliseconds of the window's VAE decodes
(`post_chunk_process`), each ending with its frames on the host."""


def read(r):
    if not r.decode_seconds:
        return None
    return 1e3 * sum(r.decode_seconds) / len(r.decode_seconds)
