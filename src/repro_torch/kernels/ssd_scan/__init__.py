from .ssd_scan import (
    CHUNK, LAUNCHES, MAX_N, scan_ops, ssd_scan, ssd_scan_plain,
)

__all__ = ["CHUNK", "LAUNCHES", "MAX_N", "scan_ops", "ssd_scan",
           "ssd_scan_plain"]
