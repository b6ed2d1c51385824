"""Checkpoints; port of `repro/ckpt/store.py`, in numpy and hashlib.

Single-file engine checkpoints:

`save_atomic` is write-temp-fsync-rename with an embedded magic tag and
a per-content sha256; `verify` loads with typed `CheckpointCorrupt`
errors naming the path and the detected failure (unreadable or
truncated archive, bad magic, checksum mismatch, missing key);
`RetentionPolicy` + `list_checkpoints` give a cadenced checkpoint
directory keep-last-K semantics. The magic bytes, the integrity key
names and the digest are the reference's, so a file written by either
package verifies in the other.

The trainer's pytree store: `save` writes <dir>/step_<n>/arrays.npz
(one array per leaf, keyed by the "/"-join of its path: dict keys, list
indices, `AdamWState` field names) and a manifest.json with the keys,
the exotic dtypes and the sha256 of arrays.npz, in a temporary
directory renamed into place after the manifest's fsync; `latest_step`
only sees renamed directories; `restore` verifies the digest (raising
`CheckpointCorrupt`) and fills a template's structure, each leaf cast
to the template's dtype and placed on its device; `AsyncWriter` saves a
host snapshot in a background thread. bf16 leaves are stored as their
uint16 bits with the manifest's dtype entry, as the reference writes
them, and restored without `ml_dtypes`: files cross between the
packages both ways. `restore(..., shardings=)` places each leaf by its
spec on a mesh (`sharding.collectives.shard`: one part a mesh position,
views on repeated devices), so a file saved from one mesh restores onto
another, as the reference's "elastic across mesh changes" restore.
A placed state (`collectives.Placed` leaves: a model's parameters and
its optimizer state on a mesh) is saved as whole leaves, joined on the
host, as the reference's save of a sharded state writes them, and a
`Placed` template leaf restores onto parts: its own layout, or the
`shardings` leaf's where one is given.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.sharding.collectives import Placed, shard
from repro_torch.tree import (
    tree_flatten_with_path,
    tree_map,
    tree_unflatten_like,
)


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


# ---------------------------------------------------------------------------
# The trainer's pytree store
# ---------------------------------------------------------------------------

_BITS = {1: np.uint8, 2: np.uint16, 4: np.uint32}
_HASH_CHUNK = 1 << 26


def _host(leaf) -> tuple[np.ndarray, Optional[str]]:
    """(a leaf as a numpy array, its exotic dtype's name or None); a bf16
    tensor as its bits, viewed as int16 (numpy has no bfloat16); a
    `Placed` leaf joined on the host."""
    if isinstance(leaf, Placed):  # joined on its first device, then one copy
        leaf = leaf.whole()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name not in np.sctypeDict:
        return arr, arr.dtype.name  # an ml_dtypes array of the reference's
    return arr, None


def _flatten(tree: Any) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Returns (arrays, exotic-dtype map): exotic leaves as the uint view
    of their width, the manifest recording the real dtype."""
    flat, dtypes = {}, {}
    for key, leaf in tree_flatten_with_path(tree):
        arr, exotic = _host(leaf)
        if exotic is not None:
            dtypes[key] = exotic
            arr = arr.view(_BITS[arr.dtype.itemsize])
        flat[key] = arr
    return flat, dtypes


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_HASH_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def save(tree: Any, directory: str, step: int) -> str:
    """Synchronous checkpoint write. Returns the checkpoint path."""
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    flat, dtypes = _flatten(tree)
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "dtypes": dtypes,
        "sha256": _sha256_file(npz_path),
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _leaf_like(arr: np.ndarray, exotic: Optional[str], leaf, sh=None):
    """The stored array as the template leaf's type, dtype and device; a
    `Placed` template leaf lands on the parts of its layout, or of `sh`'s
    (each part copied from the host array)."""
    if isinstance(leaf, Placed):  # one copy to the first device, then split
        spec, mesh = (leaf.spec, leaf.mesh) if sh is None else (sh.spec,
                                                                sh.mesh)
        t = _leaf_like(arr, exotic, torch.empty(
            (), dtype=leaf.dtype, device=mesh.device_list()[0]))
        return Placed.empty(t.shape, t.dtype, spec, mesh).copy_(t)
    if isinstance(leaf, torch.Tensor):
        if exotic not in (None, "bfloat16"):
            raise TypeError(f"a {exotic} leaf has no torch counterpart here")
        t = torch.from_numpy(arr if exotic is None else arr.view(np.int16))
        if exotic is not None:
            t = t.view(torch.bfloat16)
        return t.to(device=leaf.device, dtype=leaf.dtype, copy=True)
    if exotic is not None:
        raise TypeError(f"a {exotic} leaf restores only into a tensor "
                        "template (numpy has no such dtype)")
    dt = getattr(leaf, "dtype", None)
    return arr.astype(dt) if dt is not None and arr.dtype != dt else arr


def restore(template: Any, directory: str, step: Optional[int] = None,
            shardings: Any = None) -> Any:
    """Restore into the structure of `template`: each leaf takes the
    template leaf's dtype and device. With `shardings` (a tree of
    `NamedSharding`s on the CURRENT mesh, shaped as `template`) each
    leaf comes back as its parts, one a mesh position in row-major
    order, split by its spec (`collectives.unshard` joins them); a
    `Placed` template leaf comes back as a `Placed`, in its own layout
    without `shardings`. Raises
    `CheckpointCorrupt` when arrays.npz does not match the manifest's
    sha256."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    npz_path = os.path.join(path, "arrays.npz")
    digest = _sha256_file(npz_path)
    if digest != manifest["sha256"]:
        raise CheckpointCorrupt(
            f"checkpoint {path!r} failed verification: arrays.npz "
            f"checksum mismatch vs manifest (stored "
            f"{manifest['sha256'][:12]}…, file {digest[:12]}…)")
    exotic = manifest.get("dtypes", {})
    flat = tree_flatten_with_path(template)
    sh_leaves = ([sh for _, sh in tree_flatten_with_path(shardings)]
                 if shardings is not None else [None] * len(flat))
    out = []
    with np.load(npz_path) as data:
        for (key, leaf), sh in zip(flat, sh_leaves):
            if isinstance(leaf, Placed):
                out.append(_leaf_like(data[key], exotic.get(key), leaf, sh))
                continue
            arr = _leaf_like(data[key], exotic.get(key), leaf)
            if sh is not None:
                arr = shard(torch.as_tensor(arr).to(
                    sh.mesh.device_list()[0]), sh.spec, sh.mesh)
            out.append(arr)
    return tree_unflatten_like(template, out)


class AsyncWriter:
    """Background checkpoint writer (one in flight; drops none)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def submit(self, tree: Any, directory: str, step: int) -> None:
        self.wait()
        # snapshot off the device (a copy: the trainer updates in place)
        host_tree = tree_map(
            lambda x: (x.whole("cpu") if isinstance(x, Placed) else
                       x.detach().to("cpu", copy=True)
                       if isinstance(x, torch.Tensor) else np.array(x)),
            tree)

        def work():
            self.last_path = save(host_tree, directory, step)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
