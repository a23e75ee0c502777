"""The host-sync census: every call that makes the host wait for the card
during one partition.

Under `torch.cuda.set_sync_debug_mode("warn")` torch warns at each
synchronizing call (.item(), a device-to-host copy, nonzero, ...); each
warning is counted at the innermost frame inside the program's package.
A copy of the census of `chip_smoke.py`'s phase 16c, kept here so that the
yardstick does not move with the program.
"""

from __future__ import annotations

import os
import sys
import warnings


def count_syncs(solve, torch, package_dir: str):
    """Run `solve()` under the sync debug mode "warn".  Returns (its
    result, {"syncs", "outside", "sites"}): warnings at a package frame,
    warnings with none, and the ten busiest package file:line sites.  The
    mode is reset even on error."""
    package = os.path.join(os.path.abspath(package_dir), "")
    root = os.path.dirname(os.path.dirname(package))
    sites = {}
    outside = [0]
    show = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            show(message, category, filename, lineno, file, line)
            return
        frame = sys._getframe(1)
        while frame is not None and not frame.f_code.co_filename.startswith(
                package):
            frame = frame.f_back
        if frame is None:
            outside[0] += 1
            return
        key = f"{os.path.relpath(frame.f_code.co_filename, root)}:{frame.f_lineno}"
        sites[key] = sites.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = solve()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    busiest = sorted(sites.items(), key=lambda kv: -kv[1])[:10]
    return result, {"syncs": sum(sites.values()), "outside": outside[0],
                    "sites": [[site, count] for site, count in busiest]}
