"""Single-file engine checkpoints; port of the single-file half of
`repro/ckpt/store.py`, in numpy and hashlib.

`save_atomic` is write-temp-fsync-rename with an embedded magic tag and
a per-content sha256; `verify` loads with typed `CheckpointCorrupt`
errors naming the path and the detected failure (unreadable or
truncated archive, bad magic, checksum mismatch, missing key);
`RetentionPolicy` + `list_checkpoints` give a cadenced checkpoint
directory keep-last-K semantics. The magic bytes, the integrity key
names and the digest are the reference's, so a file written by either
package verifies in the other.

The reference's pytree store (`save`, `restore`, `latest_step`,
`AsyncWriter`) serves only its trainer and is not ported here.
"""
from __future__ import annotations

import glob
import hashlib
import os
import re
from dataclasses import dataclass

import numpy as np


class CheckpointCorrupt(Exception):
    """A checkpoint failed integrity verification. The message names
    the offending path and the detected failure mode (unreadable or
    truncated archive, bad magic, checksum mismatch, missing key)."""


# magic + format version embedded in every hardened engine checkpoint;
# files without it (raw np.savez snapshots) still verify via the legacy
# branch so old checkpoints keep restoring
_CKPT_MAGIC = b"REPRO-CKPT-v1"
_MAGIC_KEY = "__ckpt_magic__"
_SHA_KEY = "__ckpt_sha256__"


def _with_npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _digest_arrays(arrays: dict) -> str:
    """Content digest over (key, dtype, shape, bytes) in sorted key
    order — independent of npz member ordering/compression details."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def save_atomic(path: str, arrays: dict) -> str:
    """Atomic single-file checkpoint write: the payload (plus magic tag
    and content sha256) lands in a same-directory temp file, is
    fsync'd, then renamed over `path`, and the directory is fsync'd so
    the rename survives a power cut. A crash mid-save never leaves a
    half-written file where a valid checkpoint (or nothing) should be.
    Returns the final path (with `.npz`)."""
    path = _with_npz(path)
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    digest = _digest_arrays(payload)
    payload[_MAGIC_KEY] = np.frombuffer(_CKPT_MAGIC, np.uint8).copy()
    payload[_SHA_KEY] = np.frombuffer(digest.encode("ascii"),
                                      np.uint8).copy()
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        except OSError:
            pass  # some filesystems reject directory fsync; best effort
        finally:
            os.close(dfd)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def verify(path: str, required: tuple = ()) -> dict:
    """Load + integrity-check a single-file checkpoint.

    Returns {key: np.ndarray} with the integrity keys stripped. Raises
    `CheckpointCorrupt` naming `path` and the failure: an unreadable or
    truncated archive, a bad magic tag, a content-checksum mismatch, or
    a missing required key. Files without the magic tag (raw np.savez
    snapshots) skip the checksum comparison but still get readability
    and required-key checks. A missing file raises FileNotFoundError."""
    path = _with_npz(path)
    try:
        with np.load(path) as z:
            arrays = {k: np.asarray(z[k]) for k in z.files}
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CheckpointCorrupt(
            f"checkpoint {path!r} is unreadable (truncated or not a "
            f"valid npz archive): {type(e).__name__}: {e}") from e
    if _MAGIC_KEY in arrays:
        magic = bytes(arrays.pop(_MAGIC_KEY).tobytes())
        if magic != _CKPT_MAGIC:
            raise CheckpointCorrupt(
                f"checkpoint {path!r} has a bad magic tag "
                f"({magic!r} != {_CKPT_MAGIC!r}) — not a repro "
                "checkpoint, or written by an incompatible version")
        if _SHA_KEY not in arrays:
            raise CheckpointCorrupt(
                f"checkpoint {path!r} carries a magic tag but no "
                "content checksum — partial or tampered write")
        stored = arrays.pop(_SHA_KEY).tobytes().decode("ascii", "replace")
        actual = _digest_arrays(arrays)
        if actual != stored:
            raise CheckpointCorrupt(
                f"checkpoint {path!r} failed verification: checksum "
                f"mismatch (stored {stored[:12]}…, content "
                f"{actual[:12]}…) — the file was corrupted after it "
                "was written")
    missing = [k for k in required if k not in arrays]
    if missing:
        raise CheckpointCorrupt(
            f"checkpoint {path!r} is missing required key(s) "
            f"{missing} — truncated save or foreign file")
    return arrays


# anchored: a namespaced file (`shard00__ckpt_...`) must NOT match the
# un-namespaced store, and vice versa — stores sharing one directory
# may only ever see (list, prune, restore) their own files
_CKPT_RE = re.compile(r"(?:([A-Za-z0-9][A-Za-z0-9.\-]*)__)?ckpt_(\d+)\.npz")
_NS_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9.\-]*")


def _check_namespace(namespace: str) -> str:
    if namespace and _NS_RE.fullmatch(namespace) is None:
        raise ValueError(
            f"checkpoint namespace {namespace!r} must match "
            "[A-Za-z0-9][A-Za-z0-9.-]* (no underscores: '__' separates "
            "the namespace from the checkpoint name)")
    return namespace


def checkpoint_name(window: int, namespace: str = "") -> str:
    """Canonical cadenced-checkpoint file name for a window boundary.
    With a `namespace` (one store inside a shared directory) the name
    is prefixed `<namespace>__`."""
    base = f"ckpt_{window:08d}.npz"
    return f"{_check_namespace(namespace)}__{base}" if namespace else base


def list_checkpoints(directory: str,
                     namespace: str = "") -> list[tuple[int, str]]:
    """[(window, path)] of cadenced checkpoints under `directory`
    belonging to `namespace` ("" = the un-namespaced store), sorted
    oldest -> newest. Foreign-namespace files and temp files from
    interrupted atomic saves are ignored (the match is anchored on the
    full basename)."""
    _check_namespace(namespace)
    out = []
    for p in glob.glob(os.path.join(directory, "*ckpt_*.npz")):
        m = _CKPT_RE.fullmatch(os.path.basename(p))
        if m and (m.group(1) or "") == namespace:
            out.append((int(m.group(2)), p))
    return sorted(out)


@dataclass(frozen=True)
class RetentionPolicy:
    """Keep the newest `keep_last` cadenced checkpoints; prune the
    rest oldest-first. keep_last >= 2 is what lets recovery fall back
    past a corrupt newest checkpoint."""

    keep_last: int = 3

    def validate(self) -> None:
        if self.keep_last < 1:
            raise ValueError(
                f"RetentionPolicy.keep_last must be >= 1, got "
                f"{self.keep_last}")

    def apply(self, directory: str, namespace: str = "") -> list[str]:
        """Prune beyond keep_last; returns the removed paths. Only
        files in `namespace` are counted or removed — coexisting
        stores in a shared directory never prune each other."""
        ckpts = list_checkpoints(directory, namespace)
        removed = []
        for _, p in ckpts[:max(0, len(ckpts) - self.keep_last)]:
            os.remove(p)
            removed.append(p)
        return removed
