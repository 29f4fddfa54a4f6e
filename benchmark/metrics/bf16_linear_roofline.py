"""bf16_linear_roofline: the window's bf16 linears' work at its roofline
bound (`benchmark.work`: 2·M·N·K operations at the bf16 peak, or the bf16
input, weight and output bytes at HBM bandwidth, per linear group) over the
device time of the `cublas` group of `kernel_groups.json` (the cuBLAS GEMMs
of `models/dit/model.py::_linears_shared`, with the few small ones of the
embedders and the VAE decoder beside them) (%)."""


def read(r):
    if r.trace is None:
        return None
    busy = r.trace.group_seconds(r.groups).get("cublas", 0.0)
    work = sum(op.bound_s for op in r.ops() if op.kind == "linear" and op.precision == "bf16")
    if not busy or not work:
        return None
    return 100.0 * work / busy
