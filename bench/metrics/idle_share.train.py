"""Share of the traced sub-window in which no kernel ran on the card, in
% (``torch.profiler``: the union of the kernels' intervals against the
sub-window's length on the host clock)."""
from bench.metrics.common import idle_share


def read(run):
    return idle_share(run)
