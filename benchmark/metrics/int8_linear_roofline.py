"""int8_linear_roofline: the window's w8a8 linears' work at its roofline
bound (`benchmark.work`: 2·M·N·K operations at the int8 peak, or the bf16
input, int8 weight and bf16 output bytes at HBM bandwidth, per linear group)
over the device time of the `int8_linear` group of `kernel_groups.json`
(the row quantization and the int8 GEMMs) (%)."""


def read(r):
    if r.trace is None:
        return None
    busy = r.trace.group_seconds(r.groups).get("int8_linear", 0.0)
    work = sum(op.bound_s for op in r.ops() if op.kind == "linear" and op.precision == "int8")
    if not busy or not work:
        return None
    return 100.0 * work / busy
