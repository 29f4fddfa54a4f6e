"""attn_roofline: the window's self-attention work at its roofline bound
(`benchmark.work`: operations at the bf16 peak or bytes at HBM bandwidth,
per call) over the device time of the kernels of the `self_attention`
group of `kernel_groups.json` (%)."""


def read(r):
    if r.trace is None:
        return None
    busy = r.trace.group_seconds(r.groups).get("self_attention", 0.0)
    if not busy:
        return None
    return 100.0 * sum(op.bound_s for op in r.ops() if op.kind == "self_attention") / busy
