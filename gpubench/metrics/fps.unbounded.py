"""fps.unbounded: fps (metrics/fps.py) as a per-layer metric, in the
cells whose fps spreads from run to run with the host's CPU speed by
more than the largest bound (0.25) can hold (PERF.md, section 2): every
decoded picture over the window's wall time, in a --trace 1 run's
window, which is the same as a --trace 0 run's."""
from gbench import spec

read = spec.reader("fps").read
