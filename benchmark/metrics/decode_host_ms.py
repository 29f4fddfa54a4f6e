"""decode_host_ms: the mean milliseconds of the window's decodes' host
conversion of their frames to uint8 (program span `magi/decode/to_uint8`,
`video_process.f32_cthw_to_u8_thwc`)."""

from benchmark import spans


def read(r):
    if r.trace is None:
        return None
    found = spans.program_spans(r.trace, "magi/decode/to_uint8")
    if not found:
        return None
    return 1e3 * sum(s.seconds for s in found) / len(found)
