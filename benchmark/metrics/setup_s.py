"""setup_s: seconds from the process's start to the request's: the build of
the kernels (a checkout's first run), the weights' draw and quantization,
and the capture of the walk's step variants and of the decode."""


def read(r):
    return r.setup_s
