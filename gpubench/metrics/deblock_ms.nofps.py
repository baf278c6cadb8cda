"""deblock_ms.nofps: deblock_ms (metrics/deblock_ms.py) in the cells that report fps
per layer only (fps.unbounded), where it names device_mem_gib, the
end-to-end metric they keep besides setup_s."""
from gbench import spec

read = spec.reader("deblock_ms").read
