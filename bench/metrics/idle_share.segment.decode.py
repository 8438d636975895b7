"""idle_share.segment.decode: share of the ``serve.segment`` ranges'
wall (one decode segment: its launches and the read of its tokens) in
which no kernel ran on the card, in %, over the traced sub-window.

The profiler's cost per recorded op slows the host's launches inside
that sub-window (a traced decode step's host wall reads 1.2 to 2.2 times
an untraced one's on an H100), so the share reads above what an untraced
segment leaves idle: compare it only with other traced runs."""
from bench import spans


def read(run):
    sp = spans.of(run)
    wall = sp.wall_s("serve.segment") if sp else 0.0
    return 100.0 * sp.idle_s("serve.segment") / wall if wall else None
