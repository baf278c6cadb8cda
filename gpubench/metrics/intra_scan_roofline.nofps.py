"""intra_scan_roofline.nofps: intra_scan_roofline (metrics/intra_scan_roofline.py) in the cells that report fps
per layer only (fps.unbounded), where it names device_mem_gib, the
end-to-end metric they keep besides setup_s."""
from gbench import spec

read = spec.reader("intra_scan_roofline").read
