"""Device self ms a control step under the program's span ``mesh
groups``: the per-step work that picks each lane's mesh group's static
segments and wrist pre-cull blocks where the lanes' attached meshes lie at
more than one pose (the cached frames are picked inside ``cache copy``).
The program opens that span itself, under a ``torch.profiler`` session
too; a trace without it (one mesh pose, or a program without mesh
groups) reads nothing."""

from gpu_bench.harness.trace import stage_ms

LABEL = "mesh groups"


def read(run):
    t = run.traced
    if t is None or LABEL not in t["table"].counts:
        return None
    return stage_ms(run, (LABEL,))
