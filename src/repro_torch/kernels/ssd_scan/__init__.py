from .ssd_scan import CHUNK, LAUNCHES, ssd_scan, ssd_scan_plain

__all__ = ["CHUNK", "LAUNCHES", "ssd_scan", "ssd_scan_plain"]
