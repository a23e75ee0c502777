"""Seconds to copy the host CSR to the card (graphs/csr.py):
`KaMinPar.last_timings["device-upload"]`, a timer scope that waits for the
card at its exit; the mean over the window's partitions."""

LAYER = "upload"
UNIT = "s"
MOVES = "partition_s"
PHASE = "device-upload"


def read(records):
    window = [r for r in records["window"] if PHASE in r["timings"]]
    if not window:
        return None
    return sum(r["timings"][PHASE] for r in window) / len(window)
