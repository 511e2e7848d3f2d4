"""Artifact container format: one versioned zip, atomic, checksummed.

The on-disk shape of a deployable artifact (docs/DEPLOYMENT.md):

    model.ptar                      (any name; zip container)
    |- manifest.json                index: format version, section list,
    |                               per-section sha256 + versions, the
    |                               recorded config_key and TV digest,
    |                               per-var param checksums
    |- section/<name>               one blob per section in SECTIONS

``SECTIONS`` below is THE schema: every section name the save side
writes and the load side reads is declared here once, and repo_lint
rule 11 AST-checks that ``write_section``/``read_section`` call sites
in this package only ever use literal members of it — the same
declared==runtime discipline the trace-site and family tuples carry.

Writes are atomic tmp+rename (the tensor_store idiom: unique staging
name per writer, ``os.replace`` last-writer-wins) so concurrent savers
to one path can lose a race but never produce a torn file. Reads
validate before they trust: zip + manifest readability, format version
(a FUTURE version is refused with a message, never best-effort parsed),
and a sha256 per section blob.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import zipfile
from typing import Dict, Optional, Tuple

__all__ = ["FORMAT_VERSION", "SECTIONS", "SECTION_VERSIONS",
           "MANIFEST_NAME", "ArtifactError", "ArtifactSkewError",
           "write_artifact", "read_artifact", "section_path",
           "write_section", "read_section", "sha256_hex"]

FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"

# THE section-name schema (repo_lint rule 11 pins call sites to it, a
# runtime test pins manifests to it). Order is documentation order:
#   program        frozen optimized Program (json, io._program_from_dict)
#   params         weights (npz; per-var sha256 lives in the manifest)
#   tuned_kernels  kernel + train_window winner-table slice (json)
#   memory         predicted peak-bytes polynomial (json)
#   rewrite_log    the optimizer pipeline's TV rewrite log (json; the
#                  manifest's tv_digest is the sha256 of this blob)
#   aot            torch.export programs, one per bucket
#   serving        DecodeEngine construction record (cfg/b_max/max_len)
SECTIONS = ("program", "params", "tuned_kernels", "memory",
            "rewrite_log", "aot", "serving")

# each section carries its own schema version so ONE section can evolve
# without invalidating whole artifacts: an unknown section version
# degrades that section to recompute (optional sections) or refuses the
# artifact (program/params — nothing to serve without them)
SECTION_VERSIONS = {"program": 1, "params": 1, "tuned_kernels": 1,
                    "memory": 1, "rewrite_log": 1, "aot": 1, "serving": 1}

_TMP_SEQ = itertools.count(1)


class ArtifactError(RuntimeError):
    """An artifact could not be produced or read (corrupt/truncated
    container, missing mandatory section, unusable input)."""


class ArtifactSkewError(ArtifactError):
    """Load-time validation refused the artifact: the recorded world
    (format version, config_key, TV digest, checksums) does not match
    the running process. Carries the ladder ``reason`` — one of
    ``observe.families.ARTIFACT_SKEW_REASONS`` — and is always counted
    there before it propagates; a skewed artifact is never served."""

    def __init__(self, reason: str, message: str):
        self.reason = reason
        super().__init__(message)


def sha256_hex(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


def section_path(name: str) -> str:
    """Zip member name for a section blob."""
    return "section/%s" % name


def write_section(blobs: Dict[str, bytes], manifest: dict, name: str,
                  blob: bytes) -> None:
    """Stage one section for :func:`write_artifact`: records the blob,
    its sha256 and its current schema version in the manifest. ``name``
    must be a literal member of ``SECTIONS`` at every call site
    (repo_lint rule 11)."""
    if name not in SECTIONS:
        raise ArtifactError("unknown artifact section %r (schema: %s)"
                            % (name, list(SECTIONS)))
    blobs[name] = blob
    manifest.setdefault("sections", []).append(name)
    manifest.setdefault("checksums", {})[name] = sha256_hex(blob)
    manifest.setdefault("section_versions", {})[name] = \
        SECTION_VERSIONS[name]


def write_artifact(path: str, manifest: dict,
                   blobs: Dict[str, bytes]) -> str:
    """Serialize manifest + staged sections into ONE zip file,
    atomically: full write to a unique staging name, then
    ``os.replace`` — a reader (or a racing second writer) sees either
    the old complete file or the new complete file, never a torn one."""
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    manifest = dict(manifest)
    manifest["format_version"] = FORMAT_VERSION
    manifest["sections"] = [s for s in SECTIONS if s in blobs]
    tmp = "%s.tmp.%d.%d" % (path, os.getpid(), next(_TMP_SEQ))
    try:
        # stored, not deflated: the sections are weights and exported
        # programs, float bytes that deflate shrinks by a few percent
        # at the cost of most of a save's time
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as zf:
            zf.writestr(MANIFEST_NAME,
                        json.dumps(manifest, indent=1, sort_keys=True))
            for name in manifest["sections"]:
                zf.writestr(section_path(name), blobs[name])
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def read_artifact(path: str) -> Tuple[dict, "zipfile.ZipFile"]:
    """Open + validate the container: returns ``(manifest, zipfile)``.

    Raises :class:`ArtifactSkewError` with reason ``corrupt`` for an
    unreadable/truncated zip or manifest, and ``future_version`` for a
    format newer than this runtime — both BEFORE any section is
    trusted. The caller owns closing the returned zipfile."""
    if not os.path.exists(path):
        raise ArtifactError("artifact %r does not exist" % path)
    try:
        zf = zipfile.ZipFile(path, "r")
    except (zipfile.BadZipFile, OSError) as e:
        raise ArtifactSkewError(
            "corrupt", "artifact %r is not a readable zip (%s: %s) — "
            "truncated write or not an artifact" % (path,
                                                    type(e).__name__, e))
    try:
        raw = zf.read(MANIFEST_NAME)
        manifest = json.loads(raw.decode("utf-8"))
        if not isinstance(manifest, dict):
            raise ValueError("manifest is not an object")
    except Exception as e:
        zf.close()
        raise ArtifactSkewError(
            "corrupt", "artifact %r has no readable manifest (%s: %s)"
            % (path, type(e).__name__, e))
    ver = manifest.get("format_version")
    if not isinstance(ver, int) or ver < 1:
        zf.close()
        raise ArtifactSkewError(
            "corrupt", "artifact %r manifest carries no integer "
            "format_version" % path)
    if ver > FORMAT_VERSION:
        zf.close()
        raise ArtifactSkewError(
            "future_version",
            "artifact %r is format version %d but this runtime reads "
            "<= %d — refuse rather than guess; upgrade paddle_tpu or "
            "re-export the artifact" % (path, ver, FORMAT_VERSION))
    return manifest, zf


def read_section(zf: "zipfile.ZipFile", manifest: dict,
                 name: str) -> Optional[bytes]:
    """One validated section blob, or None when the manifest does not
    list it. A listed-but-unreadable blob or a sha256 mismatch raises
    :class:`ArtifactSkewError` (``section_checksum``) — a section is
    either bitwise what the saver wrote or it is not served. ``name``
    must be a literal member of ``SECTIONS`` (repo_lint rule 11)."""
    if name not in SECTIONS:
        raise ArtifactError("unknown artifact section %r (schema: %s)"
                            % (name, list(SECTIONS)))
    if name not in (manifest.get("sections") or ()):
        return None
    try:
        blob = zf.read(section_path(name))
    except Exception as e:
        raise ArtifactSkewError(
            "section_checksum",
            "artifact section %r is listed in the manifest but "
            "unreadable (%s: %s)" % (name, type(e).__name__, e))
    want = (manifest.get("checksums") or {}).get(name)
    if want != sha256_hex(blob):
        raise ArtifactSkewError(
            "section_checksum",
            "artifact section %r fails its manifest sha256 (recorded "
            "%s, got %s) — the file was modified after export"
            % (name, want, sha256_hex(blob)))
    return blob
