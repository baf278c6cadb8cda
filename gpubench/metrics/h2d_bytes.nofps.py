"""h2d_bytes.nofps: h2d_bytes (metrics/h2d_bytes.py) in the cells that report fps
per layer only (fps.unbounded), where it names device_mem_gib, the
end-to-end metric they keep besides setup_s."""
from gbench import spec

read = spec.reader("h2d_bytes").read
