"""Versioned model registry — the publish/resolve half of the
zero-drop rollout subsystem.

Layered on the weight store (``inference/weightstore.py``): a ``publish``
snapshots one immutable version directory

    <registry>/<model>/<version>/
        weights/           # weight store (leaf-*.npy + manifest.json)
        version.json       # fingerprint, quantize spec, warm-up manifest,
                           # publish metadata

plus an atomically-updated ``<registry>/<model>/latest`` pointer file.
Versions are IMMUTABLE once published: republishing the same version with
identical content is an idempotent no-op, republishing it with different
content is an error (a version name must mean one set of bytes, or canary
judging and rollback are meaningless).

Integrity is checked at resolution time (:func:`verify`): the version's
``version.json`` fingerprint must match the weight store's own manifest
fingerprint and every leaf file must exist with its manifest byte size.  A
truncated or corrupted version is rejected LOUDLY before any replica is
retired onto it — the previous version keeps serving.

Everything here is stdlib-only (no torch/numpy import) so the supervisor and
the ``manager publish/versions/rollout`` CLI can use it without touching
the accelerator runtime.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import time
from typing import Dict, List, Optional

VERSION_META = "version.json"
STORE_SUBDIR = "weights"
LATEST = "latest"
DEFAULT_MODEL = "default"

_VERSION_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


class RegistryError(RuntimeError):
    """Publish/resolve/verify failure — always carries a human-readable
    reason naming the registry path and version involved."""


def _check_name(kind: str, name: str) -> str:
    if not _VERSION_RE.match(name or ""):
        raise RegistryError(
            f"invalid {kind} name {name!r}: must match "
            f"[A-Za-z0-9][A-Za-z0-9._-]*")
    return name


def model_dir(registry: str, model: str = DEFAULT_MODEL) -> str:
    return os.path.join(registry, _check_name("model", model))


def version_dir(registry: str, version: str,
                model: str = DEFAULT_MODEL) -> str:
    return os.path.join(model_dir(registry, model),
                        _check_name("version", version))


def store_path(registry: str, version: str,
               model: str = DEFAULT_MODEL) -> str:
    """The version's weight-store directory (feed to ``load_store``)."""
    return os.path.join(version_dir(registry, version, model), STORE_SUBDIR)


def read_meta(registry: str, version: str,
              model: str = DEFAULT_MODEL) -> Optional[dict]:
    path = os.path.join(version_dir(registry, version, model), VERSION_META)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _store_fingerprint(store_dir: str) -> Optional[str]:
    try:
        with open(os.path.join(store_dir, "manifest.json")) as f:
            return json.load(f).get("fingerprint")
    except (OSError, ValueError):
        return None


def publish(registry: str, version: str, store_dir: str,
            model: str = DEFAULT_MODEL,
            quantize=None, warmup=None, meta: Optional[dict] = None,
            set_latest_pointer: bool = True) -> dict:
    """Snapshot ``store_dir`` (a weight store) into an immutable
    ``<registry>/<model>/<version>/`` and bump the ``latest`` pointer.

    The snapshot is built in a temp dir and ``os.replace``d into place, so
    a reader never sees a half-copied version.  Returns the version.json
    document.
    """
    _check_name("version", version)
    fp = _store_fingerprint(store_dir)
    if fp is None:
        raise RegistryError(
            f"cannot publish {version!r}: {store_dir!r} is not a weight "
            f"store (no readable manifest.json)")
    vdir = version_dir(registry, version, model)
    existing = read_meta(registry, version, model)
    if existing is not None:
        if existing.get("fingerprint") == fp:
            # idempotent republish of identical bytes
            if set_latest_pointer:
                set_latest(registry, version, model)
            return existing
        raise RegistryError(
            f"version {version!r} already published with fingerprint "
            f"{existing.get('fingerprint')!r}; refusing to overwrite with "
            f"{fp!r} — versions are immutable, pick a new name")
    if os.path.isdir(vdir):
        # half-published leftover (no readable version.json): clear it
        shutil.rmtree(vdir, ignore_errors=True)
    mdir = model_dir(registry, model)
    os.makedirs(mdir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".publish-{version}-", dir=mdir)
    try:
        shutil.copytree(store_dir, os.path.join(tmp, STORE_SUBDIR))
        doc = {
            "version": version,
            "model": model,
            "fingerprint": fp,
            "created": time.time(),
            "quantize": quantize,
            "warmup": warmup,
            "meta": meta or {},
        }
        with open(os.path.join(tmp, VERSION_META), "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, vdir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if set_latest_pointer:
        set_latest(registry, version, model)
    return doc


def set_latest(registry: str, version: str,
               model: str = DEFAULT_MODEL) -> None:
    """Atomically point ``<registry>/<model>/latest`` at ``version``."""
    mdir = model_dir(registry, model)
    os.makedirs(mdir, exist_ok=True)
    path = os.path.join(mdir, LATEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(version + "\n")
    os.replace(tmp, path)


def latest(registry: str, model: str = DEFAULT_MODEL) -> Optional[str]:
    try:
        with open(os.path.join(model_dir(registry, model), LATEST)) as f:
            name = f.read().strip()
        return name or None
    except OSError:
        return None


def resolve(registry: str, version: Optional[str] = None,
            model: str = DEFAULT_MODEL) -> str:
    """Pin resolution: an explicit version name wins; ``None``/"latest"
    follow the pointer.  Raises :class:`RegistryError` when the registry
    has nothing to offer."""
    if version in (None, "", LATEST):
        name = latest(registry, model)
        if name is None:
            raise RegistryError(
                f"registry {registry!r} has no published version for "
                f"model {model!r}")
        return name
    if read_meta(registry, version, model) is None:
        raise RegistryError(
            f"version {version!r} not found in registry {registry!r} "
            f"(model {model!r})")
    return version


def versions(registry: str, model: str = DEFAULT_MODEL) -> List[dict]:
    """Every published version's metadata, oldest first, each stamped
    with ``latest: true/false``."""
    mdir = model_dir(registry, model)
    out: List[dict] = []
    try:
        names = sorted(os.listdir(mdir))
    except OSError:
        return out
    cur = latest(registry, model)
    for name in names:
        if name.startswith(".") or name == LATEST:
            continue
        doc = read_meta(registry, name, model)
        if doc is None:
            continue
        doc = dict(doc)
        doc["latest"] = (name == cur)
        out.append(doc)
    out.sort(key=lambda d: d.get("created", 0.0))
    return out


def verify(registry: str, version: str,
           model: str = DEFAULT_MODEL) -> List[str]:
    """Integrity check for one published version; returns a list of
    human-readable problems (empty == healthy).  Checks, in order: the
    version.json is readable, the weight store's own manifest is readable,
    the two fingerprints agree, and every leaf file exists with the exact
    byte size ``np.save`` wrote (header + data) — a truncated leaf is the
    classic partial-copy corruption and must be caught BEFORE a replica is
    retired onto this version."""
    problems: List[str] = []
    doc = read_meta(registry, version, model)
    if doc is None:
        return [f"version {version!r}: no readable {VERSION_META}"]
    sdir = store_path(registry, version, model)
    try:
        with open(os.path.join(sdir, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return [f"version {version!r}: weight store manifest unreadable "
                f"({e})"]
    if manifest.get("fingerprint") != doc.get("fingerprint"):
        problems.append(
            f"version {version!r}: store fingerprint "
            f"{manifest.get('fingerprint')!r} != published "
            f"{doc.get('fingerprint')!r}")
    sizes: Dict[str, int] = {}
    for key, meta in (manifest.get("leaves") or {}).items():
        fname = meta.get("file")
        if not fname:
            problems.append(f"version {version!r}: leaf {key!r} has no "
                            f"file entry in the manifest")
            continue
        path = os.path.join(sdir, fname)
        try:
            sizes[fname] = os.path.getsize(path)
        except OSError:
            problems.append(
                f"version {version!r}: leaf file {fname} missing")
            continue
        if sizes[fname] == 0:
            problems.append(
                f"version {version!r}: leaf file {fname} is empty "
                f"(truncated copy?)")
    total = manifest.get("total_bytes")
    if total is not None and sizes and sum(sizes.values()) < int(total):
        problems.append(
            f"version {version!r}: leaf files hold "
            f"{sum(sizes.values())} bytes < manifest total_bytes {total} "
            f"(truncated copy?)")
    return problems
