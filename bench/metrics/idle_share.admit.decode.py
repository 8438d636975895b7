"""idle_share.admit.decode: share of the ``serve.admit`` ranges' wall
(the scheduler's admission, every admitted request's prefill and the
host's read of its first token) in which no kernel ran on the card, in
%, over the traced sub-window."""
from bench import spans


def read(run):
    sp = spans.of(run)
    wall = sp.wall_s("serve.admit") if sp else 0.0
    return 100.0 * sp.idle_s("serve.admit") / wall if wall else None
