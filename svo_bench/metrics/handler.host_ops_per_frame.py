"""Host ``aten::`` ops per frame outside the graph replays (a replay is
one ``cudaGraphLaunch``, no aten op), over the traced keyframe
interval."""

NAME = "handler.host_ops_per_frame"
UNIT = "ops/frame"
LAYER = "host pipeline, core/pipeline.FrameHandler"
MOVES = "frames_per_s"


def read(rec):
    p = rec.get("profile")
    if rec["kind"] != "handler" or not p or not p["frames"]:
        return None
    return p["host_aten"] / p["frames"]
