"""The frozen yardstick: the card's peaks and the work (operations and
bytes) of a step and of each kernel, from the configuration and the
traffic's own bookkeeping. Copied from the port at the commit that
defined the benchmark (``launch/hlo_analysis.py``, ``chip_smoke.py``'s
phase 2), so that a later change to the port never moves the yardstick."""
