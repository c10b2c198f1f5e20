"""CLI layer: file IO, mmap, hash side-files, command dispatch.

Each command opens files, memory-maps them, enforces expected byte lengths,
calls the buffer-level protocol layer, and writes `.hash` side files.
"""

from .phase1_cmds import contribute, new_challenge

__all__ = ["new_challenge", "contribute"]
