"""Milliseconds per frame in which an op runs on the card: the union of
the traced keyframe interval's device events (overlaps counted once),
chunk by chunk, over its frames.  The profiler stretches the segment's
wall time, not the kernels' own, so this holds where the busy share of
the same segment reads low."""

NAME = "device.busy_ms_per_frame"
UNIT = "ms/frame"
LAYER = "device, H100"
MOVES = "frames_per_s"


def read(rec):
    from svo_bench.trace import busy_s
    p = rec.get("profile")
    if not p or not p["frames"] or not any(c["device"] for c in p["chunks"]):
        return None
    return 1e3 * sum(busy_s(c["device"]) for c in p["chunks"]) / p["frames"]
