"""Calls that made the host wait for the card in one partition, counted at
their innermost frame in the program's package by the census (census.py,
torch's sync debug mode "warn"), on a partition of its own."""

LAYER = "device ops, host side"
UNIT = "count"
MOVES = "partition_s"


def read(records):
    census = records.get("census")
    return None if census is None else float(census["syncs"])
