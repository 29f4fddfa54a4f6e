"""other_share: the device seconds of the `other` group of
`kernel_groups.json` (the operations no pattern names: the unfused bf16
LayerNorms, the SwiGLU or GELU, casts, copies inside a step, the CFG
combine) over the window's busy seconds, the union of every device
operation's interval (%)."""


def read(r):
    if r.trace is None:
        return None
    busy = r.trace.busy_s()
    if not busy:
        return None
    return 100.0 * r.trace.group_seconds(r.groups).get(r.groups.other["key"], 0.0) / busy
