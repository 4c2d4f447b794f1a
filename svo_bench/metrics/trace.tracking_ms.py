"""Mean per frame of the handler's tracking stage timers (SVO_TRACE,
``core/pipeline._StageTimer``, which waits for the card at every mark):
pyramid_creation + sparse_img_align + reproject + pose_optimizer +
point_optimizer, over every frame of the window."""

NAME = "trace.tracking_ms"
UNIT = "ms"
LAYER = "stages, core/pipeline SVO_TRACE timers"
MOVES = "frames_per_s"
STAGES = ("pyramid_creation", "sparse_img_align", "reproject",
          "pose_optimizer", "point_optimizer")


def tracking_s(info: dict) -> float:
    return sum(info.get(k, 0.0) for k in STAGES)


def read(rec):
    spans = rec.get("spans") or []
    if not spans:
        return None
    return 1e3 * sum(tracking_s(i) for i in spans) / len(spans)
