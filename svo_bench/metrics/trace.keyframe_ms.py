"""Mean over the window's keyframe frames of the handler's ``proc_time``
less its tracking stage timers: keyframe insertion, local BA, and the
seed update and initialisation."""

NAME = "trace.keyframe_ms"
UNIT = "ms"
LAYER = "stages, core/pipeline SVO_TRACE timers"
MOVES = "frame_ms_p95"
STAGES = ("pyramid_creation", "sparse_img_align", "reproject",
          "pose_optimizer", "point_optimizer")


def read(rec):
    kfs = [i for i in rec.get("spans") or [] if i.get("is_keyframe")]
    if not kfs:
        return None
    return 1e3 * sum(i["proc_time"] - sum(i.get(k, 0.0) for k in STAGES)
                     for i in kfs) / len(kfs)
