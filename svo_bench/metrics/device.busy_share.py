"""Share of the traced segment's wall time in which an op runs on the
card: the union of its device events (overlaps counted once, not a sum
of durations), chunk by chunk, over the chunks' wall time.  The segment
is one keyframe interval of the stream run under the profiler, whose
records stretch a graph replay: the share is that of the traced run."""

NAME = "device.busy_share"
UNIT = "%"
LAYER = "device, H100"
MOVES = "frames_per_s"


def read(rec):
    from svo_bench.trace import busy_s
    p = rec.get("profile")
    if not p or not p["wall_s"] or not any(c["device"]
                                           for c in p["chunks"]):
        return None
    return 100.0 * sum(busy_s(c["device"]) for c in p["chunks"]) \
        / p["wall_s"]
