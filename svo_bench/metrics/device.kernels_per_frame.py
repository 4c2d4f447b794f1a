"""Device events (kernels, copies, sets) per frame over the traced
keyframe interval: what fusion would take down."""

NAME = "device.kernels_per_frame"
UNIT = "kernels/frame"
LAYER = "device, H100"
MOVES = "frames_per_s"


def read(rec):
    p = rec.get("profile")
    if not p or not p["frames"]:
        return None
    n = sum(len(c["device"]) for c in p["chunks"])
    return n / p["frames"] if n else None
