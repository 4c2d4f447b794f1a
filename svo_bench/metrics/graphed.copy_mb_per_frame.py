"""MB the stage graphs copy in and out per frame (``graphed.jit_stats``:
``in_copied_mb + out_copied_mb`` over the window)."""

NAME = "graphed.copy_mb_per_frame"
UNIT = "MB/frame"
LAYER = "graphed stages, core/graphed.jit"
MOVES = "frames_per_s"


def read(rec):
    j = rec.get("jit")
    if rec["kind"] != "handler" or not j or not j["replays"]:
        return None
    return (j["in_copied_mb"] + j["out_copied_mb"]) / rec["frames"]
