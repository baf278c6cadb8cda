"""unpack_ms.nofps: unpack_ms (metrics/unpack_ms.py) in the cells that report fps
per layer only (fps.unbounded), where it names device_mem_gib, the
end-to-end metric they keep besides setup_s."""
from gbench import spec

read = spec.reader("unpack_ms").read
