"""peak_gib: the device memory the request needs at its peak up to the
window's close (GiB): `torch.cuda.max_memory_allocated` from the request's
start, a lead-in included (the tree, the cache, what the steps and decodes
allocate) plus the bytes the CUDA graphs' private pools hold unallocated at
the window's close (a captured step's activations live there between
replays).  The default pool's cached free blocks are left out: the
allocator keeps them, the request does not use them."""


def read(r):
    return r.peak_bytes / 2**30
