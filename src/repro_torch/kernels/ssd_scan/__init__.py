from .ssd_scan import (
    CHUNK, LAUNCHES, MAX_N, scan_bwd_ops, scan_ops, ssd_scan, ssd_scan_bwd_plain,
    ssd_scan_plain,
)

__all__ = ["CHUNK", "LAUNCHES", "MAX_N", "scan_bwd_ops", "scan_ops",
           "ssd_scan", "ssd_scan_bwd_plain", "ssd_scan_plain"]
