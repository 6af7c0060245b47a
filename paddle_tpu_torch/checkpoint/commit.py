"""Atomic commit protocol: a checkpoint exists completely or not at all
(a copy of ``paddle_tpu/checkpoint/commit.py``, line for line, so a
manifest either package writes passes the other's ``verify_checkpoint``).

Layout under a checkpoint root::

    root/
      step_00000042.tmp/    # in-flight save: shards stream in here
        <name>.p0.s0.npy    # sharded tensor data (atomic per-file)
        metadata.json       # serializer metadata (written after shards)
        manifest.json       # commit manifest: written LAST
      step_00000042/        # committed: the .tmp dir renamed
      LATEST                # text marker naming the newest committed dir

The manifest records the step and a ``{filename: {crc32, bytes}}`` map
of every file in the checkpoint. Because each file write is itself
atomic (fsio.py) and the manifest is written after all of them, the
single ``os.rename`` of ``step_N.tmp`` -> ``step_N`` is the commit
point: discovery only trusts directories whose manifest parses, so a
crash at ANY earlier instant leaves at worst an orphaned ``.tmp`` that
startup GC removes. ``LATEST`` is an O(1) hint, not the source of
truth — if it is stale or torn, discovery falls back to scanning.

The port writes from one process (``ROADMAP.md`` queue A item 6 brings
the multi-process write and its barrier).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time

from ..distributed.checkpoint.fsio import (
    atomic_write_text,
    crc32_file,
    fsync_dir,
)
from ..distributed.checkpoint.metadata import Metadata, metadata_path

MANIFEST_FILE = "manifest.json"
LATEST_FILE = "LATEST"
TMP_SUFFIX = ".tmp"
# when re-saving an already-committed step, the old generation is
# renamed aside to step_N.replaced.tmp for the duration of the commit
# rename (never rmtree'd while the replacement is unpublished); startup
# GC renames it back if a crash left the step with no committed dir
REPLACED_SUFFIX = ".replaced" + TMP_SUFFIX

_STEP_DIR_RE = re.compile(r"step_(\d+)")


def step_dir_name(step):
    return f"step_{int(step):08d}"


def step_dir(root, step):
    return os.path.join(root, step_dir_name(step))


def tmp_dir(root, step):
    return step_dir(root, step) + TMP_SUFFIX


def manifest_path(dirname):
    return os.path.join(dirname, MANIFEST_FILE)


def write_manifest(dirname, step, files, extra=None):
    """Write the commit manifest (atomically, then fsync the dir so the
    subsequent rename publishes durable contents)."""
    doc = {
        "version": 1,
        "step": int(step),
        "time": time.time(),
        "files": {
            str(k): {"crc32": int(v["crc32"]), "bytes": int(v["bytes"])}
            for k, v in files.items()
        },
    }
    if extra:
        doc["extra"] = extra
    atomic_write_text(manifest_path(dirname), json.dumps(doc, indent=1))
    fsync_dir(dirname)
    return doc


def read_manifest(dirname):
    """Parsed manifest dict, or None when absent/unparsable/malformed (a
    torn, hand-edited, or pre-runtime directory). Validates the fields
    every consumer relies on — an integer ``step`` and integer
    crc32/bytes per file — so discovery and verification can trust a
    non-None manifest without re-checking shapes."""
    try:
        with open(manifest_path(dirname)) as f:
            doc = json.load(f)
        files = doc.get("files")
        if not isinstance(files, dict):
            return None
        doc["step"] = int(doc["step"])
        for rec in files.values():
            rec["crc32"] = int(rec["crc32"])
            rec["bytes"] = int(rec["bytes"])
        return doc
    except (OSError, ValueError, TypeError, KeyError):
        return None


def commit(root, step):
    """The commit point: rename ``step_N.tmp`` -> ``step_N`` and refresh
    the LATEST marker. Returns the committed path."""
    src, dst = tmp_dir(root, step), step_dir(root, step)
    aside = None
    if os.path.isdir(dst):
        # a previous save of the same step (re-run after restore):
        # replace it wholesale — two generations of one step must not
        # mix. Rename the old generation ASIDE rather than rmtree'ing
        # it: a crash during an rmtree-then-rename would destroy the
        # committed generation while the replacement is still
        # unpublished, losing the step entirely. The aside copy is
        # deleted only after the new one is in place (and startup GC
        # renames it back if a crash lands between the two renames).
        aside = dst + REPLACED_SUFFIX
        if os.path.isdir(aside):
            shutil.rmtree(aside)
        os.rename(dst, aside)
        os.utime(aside, None)  # rename keeps mtime; stamp for GC's age window
    try:
        os.rename(src, dst)
    except OSError:
        if aside is not None and not os.path.isdir(dst):
            os.rename(aside, dst)  # put the old generation back
        raise
    atomic_write_text(os.path.join(root, LATEST_FILE), step_dir_name(step))
    fsync_dir(root)
    if aside is not None:
        shutil.rmtree(aside, ignore_errors=True)
    return dst


def list_candidates(root):
    """Every step-shaped directory under ``root`` (committed or not),
    newest first: [(step, path, manifest_or_None)]. ``.tmp`` dirs are
    never candidates — they were never committed."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        m = _STEP_DIR_RE.fullmatch(name)
        if not m:
            continue
        p = os.path.join(root, name)
        if not os.path.isdir(p):
            continue
        out.append((int(m.group(1)), p, read_manifest(p)))
    out.sort(reverse=True)
    return out


def list_committed(root):
    """Committed checkpoints, newest first: [(step, path)]."""
    return [
        (step, path)
        for step, path, manifest in list_candidates(root)
        if manifest is not None
    ]


def latest_committed(root):
    """Path of the newest committed checkpoint, or None. The LATEST
    marker is a fast path but only a LOWER bound: a crash between the
    commit rename and the marker write leaves it one step behind, so any
    step-shaped dir newer than the marker (a cheap name scan, no
    manifest reads) forces the full scan; a stale/torn marker falls back
    the same way."""
    try:
        with open(os.path.join(root, LATEST_FILE)) as f:
            name = f.read().strip()
        m = _STEP_DIR_RE.fullmatch(name)
        p = os.path.join(root, name)
        if m and read_manifest(p) is not None:
            marker_step = int(m.group(1))
            newer = any(
                mm and int(mm.group(1)) > marker_step
                for mm in map(_STEP_DIR_RE.fullmatch, os.listdir(root))
            )
            if not newer:
                return p
    except OSError:
        pass
    committed = list_committed(root)
    return committed[0][1] if committed else None


def verify_checkpoint(path, level="full"):
    """Integrity problems of a checkpoint directory, [] when intact.

    Checks, in order: manifest present + parsable; every manifest file
    present with the recorded size (and, at ``level="full"`` /
    ``"files"``, the recorded CRC32); serializer metadata parsable and
    referencing only manifest-covered shard files. ``level="files"``
    stops after the per-file checks — the discovery mode
    (``fleet.elastic.latest_checkpoint``) for directories that carry a
    commit manifest but no serializer metadata."""
    problems = []
    manifest = read_manifest(path)
    if manifest is None:
        return [f"manifest missing or unparsable: {manifest_path(path)}"]
    for fname, rec in manifest["files"].items():
        fpath = os.path.join(path, fname)
        if not os.path.isfile(fpath):
            problems.append(f"missing file: {fname}")
            continue
        size = os.path.getsize(fpath)
        if size != int(rec["bytes"]):
            problems.append(
                f"size mismatch: {fname} has {size} bytes, "
                f"manifest says {rec['bytes']}"
            )
            continue
        if level in ("full", "files"):
            crc, _ = crc32_file(fpath)
            if crc != int(rec["crc32"]):
                problems.append(
                    f"checksum mismatch: {fname} crc32 {crc} != "
                    f"manifest {rec['crc32']}"
                )
    if level == "files":
        return problems
    try:
        with open(metadata_path(path)) as f:
            meta = Metadata.from_json(f.read())
        for name, tmeta in meta.tensors.items():
            for sh in tmeta.shards:
                if sh.file not in manifest["files"]:
                    problems.append(
                        f"shard not covered by manifest: {sh.file} "
                        f"(tensor {name})"
                    )
    except (OSError, ValueError, KeyError) as e:
        problems.append(f"metadata unreadable: {e}")
    return problems


def gc_orphans(root, min_age_s=0.0):
    """Remove orphaned ``.tmp`` dirs (saves that died before their
    commit rename). Returns the removed paths. Call at startup, before
    this process has a save in flight. ``min_age_s`` protects OTHER
    processes sharing the root: a tmp dir modified within the window is
    presumed to be a live writer's (every shard write touches the dir —
    create + rename per file) and is left alone.

    ``step_N.replaced.tmp`` dirs (the old generation a same-step re-save
    moved aside mid-commit) get recovery instead of plain reaping: if a
    crash between commit()'s two renames left the step with NO committed
    dir, the aside copy — still intact, manifest and all — is renamed
    back into place; otherwise it is reaped like any orphan."""
    removed = []
    now = time.time()
    try:
        names = os.listdir(root)
    except OSError:
        return removed
    for name in names:
        if not name.endswith(TMP_SUFFIX):
            continue
        stem = name[: -len(TMP_SUFFIX)]
        replaced = name.endswith(REPLACED_SUFFIX)
        if replaced:
            stem = name[: -len(REPLACED_SUFFIX)]
        if not _STEP_DIR_RE.fullmatch(stem):
            continue
        p = os.path.join(root, name)
        if not os.path.isdir(p):
            continue
        if replaced and not os.path.isdir(os.path.join(root, stem)) \
                and read_manifest(p) is not None:
            # recovery is NOT age-gated: an elastic relaunch seconds
            # after a mid-commit crash must get its step back, not
            # restart from an older checkpoint until the window expires
            # (worst case against a still-LIVE committer: its commit
            # rename fails and that save errors — no data loss)
            try:
                os.rename(p, os.path.join(root, stem))
                continue  # recovered, not removed
            except OSError:
                pass
        if min_age_s > 0:
            try:
                if now - os.path.getmtime(p) < min_age_s:
                    continue  # plausibly a live writer/committer
            except OSError:
                continue
        shutil.rmtree(p, ignore_errors=True)
        removed.append(p)
    return removed
