"""mc_ms.nofps: mc_ms (metrics/mc_ms.py) in the cells that report fps
per layer only (fps.unbounded), where it names device_mem_gib, the
end-to-end metric they keep besides setup_s."""
from gbench import spec

read = spec.reader("mc_ms").read
