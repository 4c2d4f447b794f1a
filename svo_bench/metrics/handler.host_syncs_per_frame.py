"""Waits of the host on the card per frame inside ``FrameHandler``,
counted by CUDA's sync debug mode over the whole window (each wait
attributed to a line of the program; the harness's own read of the
result is not)."""

NAME = "handler.host_syncs_per_frame"
UNIT = "syncs/frame"
LAYER = "host pipeline, core/pipeline.FrameHandler"
MOVES = "frames_per_s"


def read(rec):
    s = rec.get("syncs")
    if rec["kind"] != "handler" or not s or not rec["frames"]:
        return None
    return s["count"] / rec["frames"]
