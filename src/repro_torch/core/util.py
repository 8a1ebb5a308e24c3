"""Small shared helpers for the core package."""
from __future__ import annotations


def safe_uid(uid: str) -> str:
    """Filesystem-safe encoding of a drop uid (used for payload spill files
    and checkpoint entries)."""
    return uid.replace("/", "_").replace("#", "_").replace(".", "_")
