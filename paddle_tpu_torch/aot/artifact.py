"""Versioned artifact store of the engine's programs (counterpart of
``paddle_tpu/aot/artifact.py``).

The JAX store serializes XLA executables.  A CUDA graph cannot be
serialized: its counterpart of a backend compile is the ``nvcc`` build of
the kernel library plus a capture, so an artifact directory here holds
what makes a warm start build nothing — the kernel library the programs
launch (a CRC-checked copy, on CUDA) — and one record per program: its
name, its call signature and the geometry it is captured at.  A warm
engine loads the library from the artifact and captures its programs at
construction.  Layout:

    <dir>/manifest.json       versioned manifest (atomic publish)
    <dir>/<name>.prog         one JSON record per program, CRC32'd in the
                              manifest
    <dir>/libpt_kernels.so    the kernel library (CUDA exports only)

The manifest records everything that makes a program unsafe to reuse
elsewhere: the torch and CUDA versions, the platform, the device and its
``sm`` (a captured graph and a built library are specialised to them),
the kernel sources' digest, a caller-supplied config hash (model and
engine geometry), each program's input signature and the declared shape
buckets.  ``load`` verifies all of it and raises a typed
:class:`AotError` subclass on any mismatch; callers fall back to a fresh
build and capture rather than run a wrong or corrupt program.

The JAX store's donation gate (``donation_deserialize_safe``: jax 0.4.37's
CPU client mis-executes deserialized programs with donated buffers) has
no counterpart: the port donates nothing (the pools are updated in place
by the kernels) and deserializes no program.  Its telemetry events are
not kept (the port has no metrics registry yet, ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = [
    "AotError", "AotArtifactCorruptError", "AotManifestMismatchError",
    "AotDonationError", "ArtifactStore", "environment_fingerprint",
    "config_hash", "args_signature", "MANIFEST_MAGIC", "LATEST_POINTER",
    "new_generation", "read_latest", "resolve_artifact_dir",
]

MANIFEST_MAGIC = "paddle_tpu_torch.aot.v1"
_MANIFEST = "manifest.json"
_LIBRARY = "libpt_kernels.so"
#: rotation-root pointer file naming the live generation subdirectory
LATEST_POINTER = "latest"
_GEN_PREFIX = "gen-"
_TMP_PREFIX = ".tmp-"


class AotError(RuntimeError):
    """Base: an artifact cannot be used; fall back to a fresh build."""


class AotArtifactCorruptError(AotError):
    """A program record, the library copy or the manifest is truncated,
    unreadable, or fails its CRC — the directory should be re-exported."""


class AotManifestMismatchError(AotError):
    """The artifact was built for another environment or config (torch /
    CUDA version skew, another device, changed kernel sources or model
    geometry, a missing program).  Not corruption — just not ours."""


class AotDonationError(AotError):
    """Kept for the JAX package's error set: the port donates nothing, so
    nothing raises it."""


def _replace(tmp: str, path: str) -> None:
    os.replace(tmp, path)


def _fsync_dir(d: str) -> None:
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(data: bytes, path: str) -> None:
    """Publish ``data`` at ``path``: same-directory temp file, fsync,
    ``os.replace``, directory fsync.  Readers never see a partial file; a
    crash leaves only a ``.tmp-*`` straggler."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=_TMP_PREFIX,
                               suffix="-" + os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        _replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d)


def environment_fingerprint(device=None) -> Dict[str, Any]:
    """Everything a captured graph and the kernel library are specialised
    to besides their inputs: the torch and CUDA versions, the platform,
    the kernel sources' digest and, on CUDA, the device's name and
    ``sm``."""
    from ..kernels import build
    dev = torch.device("cpu" if device is None else device)
    env = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "platform": dev.type, "kernels": build.source_digest()}
    if dev.type == "cuda":
        p = torch.cuda.get_device_properties(dev)
        env["device"] = p.name
        env["sm"] = f"{p.major}{p.minor}"
    return env


def config_hash(config: Dict[str, Any]) -> str:
    """Stable digest of a JSON-able config dict."""
    import hashlib
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _flatten(x, leaves: List) -> str:
    """The structure of a tree of dicts (keys sorted, as JAX flattens
    them), named tuples, tuples, lists and None; its other nodes are
    leaves, appended to ``leaves``."""
    if isinstance(x, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(x[k], leaves)}"
                               for k in sorted(x)) + "}"
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (f"{type(x).__name__}("
                + ", ".join(_flatten(v, leaves) for v in x) + ")")
    if isinstance(x, (tuple, list)):
        inner = ", ".join(_flatten(v, leaves) for v in x)
        return f"({inner})" if isinstance(x, tuple) else f"[{inner}]"
    if x is None:
        return "None"
    leaves.append(x)
    return "*"


def _leaf_sig(x) -> List:
    shape = getattr(x, "shape", None)
    if shape is None:
        return [[], type(x).__name__]
    return [list(shape), str(getattr(x, "dtype", "?"))]


def args_signature(args: Tuple) -> Tuple[str, List]:
    """(tree structure, per-leaf [shape, dtype]) of a call-args tuple of
    torch tensors (or numpy arrays, or scalars): recorded in the manifest
    at export time, matched against it at load time."""
    leaves: List = []
    td = _flatten(args, leaves)
    return td, [_leaf_sig(v) for v in leaves]


def _sig_matches(entry_sig, args) -> bool:
    td, leaves = args_signature(args)
    return list(entry_sig) == [td, leaves]


# ---------------------------------------------------------------------
# rotation roots: a ROOT directory holds numbered generation subdirs plus
# a LATEST pointer published atomically; gc() prunes old generations
# without ever touching the one the pointer names
# ---------------------------------------------------------------------
def _generation_dirs(root: str) -> List[str]:
    """Generation subdirectory names under ``root``, oldest first."""
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    gens = []
    for n in names:
        if n.startswith(_GEN_PREFIX) and os.path.isdir(
                os.path.join(root, n)):
            try:
                gens.append((int(n[len(_GEN_PREFIX):]), n))
            except ValueError:
                continue
    return [n for _, n in sorted(gens)]


def new_generation(root: str) -> "ArtifactStore":
    """Create the next ``gen-NNNN`` subdirectory under a rotation root and
    return an :class:`ArtifactStore` for it.  The generation is invisible
    to loaders until :meth:`ArtifactStore.publish` moves the ``latest``
    pointer."""
    gens = _generation_dirs(root)
    nxt = 1 + (int(gens[-1][len(_GEN_PREFIX):]) if gens else 0)
    d = os.path.join(root, f"{_GEN_PREFIX}{nxt:04d}")
    os.makedirs(d, exist_ok=True)
    return ArtifactStore(d)


def read_latest(root: str) -> Optional[str]:
    """The generation directory the ``latest`` pointer names, or None
    when ``root`` is not a rotation root."""
    try:
        with open(os.path.join(root, LATEST_POINTER),
                  encoding="utf-8") as f:
            name = f.read().strip()
    except (FileNotFoundError, NotADirectoryError):
        return None
    return os.path.join(root, os.path.basename(name)) if name else None


def resolve_artifact_dir(path: str) -> str:
    """A plain artifact directory resolves to itself; a rotation root
    through its ``latest`` pointer.  A pointer naming a missing generation
    is corruption (the pointer is published after the generation's
    manifest, so someone deleted the live generation)."""
    if os.path.exists(os.path.join(path, _MANIFEST)):
        return path
    pointed = read_latest(path)
    if pointed is None:
        return path
    if not os.path.exists(os.path.join(pointed, _MANIFEST)):
        raise AotArtifactCorruptError(
            f"{path}: latest pointer names {os.path.basename(pointed)!r}"
            " but that generation has no manifest — the live generation "
            "was deleted out from under the pointer; re-export")
    return pointed


class ArtifactStore:
    """One artifact directory: a manifest plus CRC'd program records and
    (on CUDA) the kernel library's copy, written atomically and verified
    on read."""

    def __init__(self, directory: str):
        self.directory = directory
        self._manifest: Optional[Dict[str, Any]] = None

    # -- write side ----------------------------------------------------
    def begin(self, *, config: Dict[str, Any],
              buckets: Optional[Dict[str, Any]] = None,
              device=None) -> "ArtifactStore":
        """Start a fresh manifest for this export run, stamped with the
        environment of ``device``."""
        self._manifest = {
            "magic": MANIFEST_MAGIC,
            "version": 1,
            "env": environment_fingerprint(device),
            "config": config,
            "config_hash": config_hash(config),
            "buckets": buckets,
            "executables": {},
            "library": None,
        }
        return self

    def extend(self) -> "ArtifactStore":
        """Reopen this store's on-disk manifest for appending."""
        if self._manifest is None:
            self._manifest = self.manifest()
        return self

    def _put_bytes(self, fname: str, blob: bytes) -> Dict[str, Any]:
        os.makedirs(self.directory, exist_ok=True)
        atomic_write_bytes(blob, os.path.join(self.directory, fname))
        return {"file": fname, "crc32": zlib.crc32(blob), "size": len(blob)}

    def put(self, name: str, record: Dict[str, Any],
            example_args: Tuple) -> None:
        """Store one program's record (a JSON-able dict: what it runs and
        the geometry it is captured at) under ``name``.  ``example_args``
        is its exact call signature, recorded so loaders can match it
        without a failed call."""
        if self._manifest is None:
            raise AotError("ArtifactStore.put before begin()")
        td, leaves = args_signature(example_args)
        entry = self._put_bytes(
            f"{name}.prog",
            json.dumps({"name": name, **record}, sort_keys=True,
                       default=str).encode())
        entry["in_sig"] = [td, leaves]
        self._manifest["executables"][name] = entry
        self._flush()

    def put_library(self, path, digest: str) -> None:
        """Store a copy of the kernel library at ``path``, built from the
        sources of ``digest``."""
        if self._manifest is None:
            raise AotError("ArtifactStore.put_library before begin()")
        with open(path, "rb") as f:
            blob = f.read()
        entry = self._put_bytes(_LIBRARY, blob)
        entry["digest"] = digest
        self._manifest["library"] = entry
        self._flush()

    def _flush(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        atomic_write_bytes(
            json.dumps(self._manifest, indent=1, default=str).encode(),
            os.path.join(self.directory, _MANIFEST))

    # -- rotation ------------------------------------------------------
    def publish(self, keep_last: Optional[int] = None) -> str:
        """Point the parent rotation root's ``latest`` at this (fully
        written) generation, atomically: a crash mid-publish leaves the
        previous pointer intact and loadable.  With ``keep_last``, old
        generations are pruned afterwards (pointer first, then gc).
        Returns the root."""
        if not self.exists():
            raise AotError(f"{self.directory}: publish() before any "
                           "program was put — nothing to point at")
        root = os.path.dirname(os.path.abspath(self.directory))
        atomic_write_bytes(os.path.basename(self.directory).encode(),
                           os.path.join(root, LATEST_POINTER))
        if keep_last is not None:
            ArtifactStore(root).gc(keep_last=keep_last)
        return root

    def gc(self, keep_last: int) -> List[str]:
        """Prune old generations under this ROOT directory, keeping the
        ``keep_last`` newest and, whatever its age, the one the ``latest``
        pointer names.  Returns removed paths."""
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        root = self.directory
        gens = _generation_dirs(root)
        pointed = read_latest(root)
        keep = set(gens[-keep_last:])
        if pointed is not None:
            keep.add(os.path.basename(pointed))
        removed = []
        for name in gens:
            if name in keep:
                continue
            path = os.path.join(root, name)
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
        return removed

    # -- read side -----------------------------------------------------
    def exists(self) -> bool:
        return os.path.exists(os.path.join(self.directory, _MANIFEST))

    def manifest(self) -> Dict[str, Any]:
        """Parse and structurally validate the manifest (cached)."""
        if self._manifest is not None:
            return self._manifest
        path = os.path.join(self.directory, _MANIFEST)
        try:
            with open(path, "rb") as f:
                m = json.loads(f.read())
        except FileNotFoundError:
            raise AotManifestMismatchError(
                f"{self.directory}: no AOT manifest")
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise AotArtifactCorruptError(
                f"{path}: manifest unreadable: {e}") from e
        if not isinstance(m, dict) or m.get("magic") != MANIFEST_MAGIC:
            magic = m.get("magic") if isinstance(m, dict) else None
            raise AotManifestMismatchError(
                f"{path}: not a {MANIFEST_MAGIC} manifest "
                f"(magic={magic!r})")
        if not isinstance(m.get("executables"), dict):
            raise AotArtifactCorruptError(
                f"{path}: manifest has no executables table")
        self._manifest = m
        return m

    def check_env(self, device=None) -> None:
        """Version and device skew gate: a program captured against
        another torch, CUDA, device or kernel sources is never used."""
        want = self.manifest().get("env") or {}
        have = environment_fingerprint(device)
        drift = {k: (want.get(k), have[k]) for k in have
                 if want.get(k) != have[k]}
        if drift:
            raise AotManifestMismatchError(
                f"{self.directory}: environment skew {drift} — artifacts "
                "must be re-exported for this environment")

    def check_config(self, config: Dict[str, Any]) -> None:
        m = self.manifest()
        want = config_hash(config)
        if m.get("config_hash") != want:
            raise AotManifestMismatchError(
                f"{self.directory}: config hash {m.get('config_hash')!r} "
                f"!= expected {want!r} (model/engine geometry changed)")

    def buckets(self) -> Optional[Dict[str, Any]]:
        return self.manifest().get("buckets")

    def entry(self, name: str) -> Dict[str, Any]:
        entry = self.manifest()["executables"].get(name)
        if entry is None:
            raise AotManifestMismatchError(
                f"{self.directory}: no executable {name!r} in manifest")
        return entry

    def matches_signature(self, name: str, args: Tuple) -> bool:
        """Does ``name``'s recorded input signature match ``args``?"""
        return _sig_matches(self.entry(name)["in_sig"], args)

    def _read_checked(self, entry: Dict[str, Any], what: str) -> bytes:
        path = os.path.join(self.directory, entry["file"])
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise AotArtifactCorruptError(
                f"{path}: {what} unreadable: {e}") from e
        if zlib.crc32(blob) != entry["crc32"]:
            raise AotArtifactCorruptError(
                f"{path}: CRC mismatch — artifact is corrupt (bit-rot or "
                "torn write); re-export")
        return blob

    def get(self, name: str) -> Dict[str, Any]:
        """CRC-verify and parse ``name``'s program record."""
        blob = self._read_checked(self.entry(name), "program record")
        try:
            rec = json.loads(blob)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise AotArtifactCorruptError(
                f"{self.directory}/{name}: program record unreadable: "
                f"{e}") from e
        if rec.get("name") != name:
            raise AotManifestMismatchError(
                f"{self.directory}: record of {rec.get('name')!r} filed "
                f"as {name!r}")
        return rec

    def library(self) -> Tuple[str, str]:
        """CRC-verify the kernel library's copy; returns ``(path, source
        digest)``.  Raises when the artifact holds none (a CPU export)."""
        entry = self.manifest().get("library")
        if not entry:
            raise AotManifestMismatchError(
                f"{self.directory}: no kernel library in the manifest (a "
                "CPU export cannot warm-start a CUDA engine)")
        self._read_checked(entry, "kernel library")
        return os.path.join(self.directory, entry["file"]), entry["digest"]
