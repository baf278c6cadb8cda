"""device_idle_share.nofps: device_idle_share (metrics/device_idle_share.py) in the cells that report fps
per layer only (fps.unbounded), where it names device_mem_gib, the
end-to-end metric they keep besides setup_s."""
from gbench import spec

read = spec.reader("device_idle_share").read
