"""Mean dirty 8x128 tiles per env, fixed camera and control step, from
the evaluator's ``render_telemetry`` over the traced steps."""


def read(run):
    return run.extra.get("dirty_tiles")
