"""mmap-backed file helpers for the CLI layer.

Mirrors the reference's file handling (phase1-cli/src/contribute.rs:28-77):
inputs are mapped read-only after a strict length check; outputs are created
with create_new semantics (never overwrite) at a preallocated length and
mapped read-write.
"""

from __future__ import annotations

import mmap
import os

from ..utils.errors import InvalidLengthError


def open_readable_map(path: str, expected_length: int) -> mmap.mmap:
    """Open + length-check + mmap a file read-only.

    The strict length precondition is the reference's first line of failure
    detection (contribute.rs:41-47)."""
    size = os.path.getsize(path)
    if size != expected_length:
        raise InvalidLengthError(expected_length, size)
    f = os.open(path, os.O_RDONLY)
    try:
        return mmap.mmap(f, 0, prot=mmap.PROT_READ)
    finally:
        os.close(f)


def create_writable_map(path: str, length: int) -> mmap.mmap:
    """Create a new file (refusing to overwrite, like OpenOptions
    create_new(true) — new_challenge.rs:26) of `length` bytes and mmap it
    read-write."""
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o644)
    try:
        os.ftruncate(fd, length)
        return mmap.mmap(fd, 0, prot=mmap.PROT_READ | mmap.PROT_WRITE)
    finally:
        os.close(fd)


def write_to_file(path: str, data: bytes) -> None:
    """Reference: setup-utils/src/io/mod.rs:17-21 (truncating write)."""
    with open(path, "wb") as f:
        f.write(data)
