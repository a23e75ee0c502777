"""Durable array snapshots for checkpoint/resume (own copy of
kaminpar_tpu/io/snapshot.py: the same magic, container and checksums, so
a snapshot written by either package reads in the other).

An ``.npz`` file with a magic key and named numpy arrays, written with
``np.savez_compressed``:

  * **atomic**: written to a temp file in the target directory, fsync'd,
    then ``os.replace``'d over the final name (and the directory entry
    fsync'd), so a kill mid-write never leaves a half-written file under
    the final name;
  * **verifiable**: the writer returns the byte count and the SHA-256 of
    the written file; the reader re-hashes and refuses content that does
    not match the recorded checksum (:class:`SnapshotError`).  A file
    read without a checksum that fails the zip layer's CRC raises
    SnapshotError too (the JAX package lets zipfile.BadZipFile through).
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import zipfile
from typing import Dict, Tuple

import numpy as np

SNAPSHOT_MAGIC = "kaminpar-tpu-snapshot-v1"


class SnapshotError(ValueError):
    """A snapshot file is unreadable, has no magic, or fails its
    checksum.  Mapped to resilience.CheckpointCorrupt by the manager."""


def write_snapshot(path: str, arrays: Dict[str, np.ndarray]) -> Tuple[int, str]:
    """Atomically write ``arrays`` as an npz snapshot at ``path``.

    Returns ``(num_bytes, sha256_hex)`` of the written file.  Raises
    OSError on filesystem failure (the caller maps it to the
    ``checkpoint-write`` degradation site).
    """
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(
                f,
                magic=np.frombuffer(SNAPSHOT_MAGIC.encode(), dtype=np.uint8),
                **{k: np.asarray(v) for k, v in arrays.items()},
            )
            f.flush()
            os.fsync(f.fileno())
        # hash in fixed chunks (zipfile seeks back to patch headers, so
        # tee-hashing during the write would record the wrong bytes; a
        # whole-file read would spike host RAM by the snapshot size on
        # the hour-class hierarchies checkpointing exists for)
        nbytes, sha = _hash_file(tmp)
        os.replace(tmp, path)
        tmp = None
        _fsync_dir(directory)
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return nbytes, sha


_HASH_CHUNK = 1 << 22  # 4 MiB


def _hash_file(path: str):
    """(num_bytes, sha256_hex) of a file, read in fixed chunks."""
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_HASH_CHUNK)
            if not chunk:
                break
            h.update(chunk)
            n += len(chunk)
    return n, h.hexdigest()


def read_snapshot(
    path: str, expect_sha256: str | None = None
) -> Dict[str, np.ndarray]:
    """Read a snapshot, verifying magic and (optionally) the checksum
    (chunked — the file is not buffered whole for hashing).

    Raises SnapshotError on a missing magic or checksum mismatch and
    OSError on filesystem failure.
    """
    if expect_sha256 is not None:
        _, got = _hash_file(path)
        if got != expect_sha256:
            raise SnapshotError(
                f"{path}: checksum mismatch (manifest {expect_sha256[:12]}…, "
                f"file {got[:12]}…) — truncated or corrupted snapshot"
            )
    try:
        with np.load(path) as z:
            if "magic" not in z or bytes(z["magic"]).decode() != SNAPSHOT_MAGIC:
                raise SnapshotError(f"{path}: not a kaminpar-tpu snapshot")
            return {k: z[k] for k in z.files if k != "magic"}
    except (ValueError, OSError, zipfile.BadZipFile) as e:
        # zip/npz layer failures (a flipped byte read back without a
        # checksum fails the zip CRC)
        if isinstance(e, SnapshotError):
            raise
        raise SnapshotError(f"{path}: unreadable snapshot ({e})") from e


def _fsync_dir(directory: str) -> None:
    """fsync a directory entry so a rename survives power loss; best
    effort on filesystems that refuse O_RDONLY dir fsync."""
    try:
        dfd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)
