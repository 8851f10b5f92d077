"""Checkpoint / resume for long tiled runs.

The reference's only crash-resilience is an append-mode log flushed per
stage (SURVEY.md §5). This module generalizes that: a run directory
holds a JSON manifest of completed work units plus one .npy part per
unit, written atomically (temp + rename). A restarted run skips
completed units.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np


class CheckpointManager:
    """Atomic per-unit result store with a completion manifest."""

    MANIFEST = "manifest.json"
    CONFIG_KEY = "__config__"

    def __init__(
        self,
        directory: str,
        config: dict | None = None,
        config_defaults: dict | None = None,
    ):
        """``config``: the run's identity (graph fingerprint, tiling, k…).
        On resume it must equal the stored one — a reused directory from a
        different run fails loudly instead of returning stale results.

        ``config_defaults``: values assumed for keys ABSENT from the
        stored config — lets a newer version add identity keys without
        invalidating old directories whose runs used the defaults."""
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._manifest_path = self.dir / self.MANIFEST
        self._done: dict[str, dict] = {}
        if self._manifest_path.exists():
            self._done = json.loads(self._manifest_path.read_text())
        if config is not None:
            stored = self._done.get(self.CONFIG_KEY)
            if stored is not None and config_defaults:
                stored = {**config_defaults, **stored}
            if stored is not None and stored != config:
                if stored.get("format") != config.get("format"):
                    raise ValueError(
                        f"checkpoint directory {directory} was written with "
                        f"on-disk format {stored.get('format')!r} but this "
                        f"version uses {config.get('format')!r}: the stored "
                        "units cannot be resumed — delete the directory to "
                        "re-run from scratch"
                    )
                raise ValueError(
                    f"checkpoint directory {directory} belongs to a different "
                    f"run: stored config {stored} != requested {config}"
                )
            if stored is None:
                self._done[self.CONFIG_KEY] = config
                _atomic_write_text(
                    self._manifest_path,
                    json.dumps(self._done, indent=0, sort_keys=True),
                )

    # -- unit tracking -----------------------------------------------------

    def is_done(self, key: str) -> bool:
        return key != self.CONFIG_KEY and key in self._done

    def done_keys(self) -> list[str]:
        return sorted(k for k in self._done if k != self.CONFIG_KEY)

    def save_unit(self, key: str, **arrays: np.ndarray) -> None:
        """Persist a completed unit's arrays and mark it done (atomic:
        arrays land before the manifest references them, so a crash
        mid-write leaves the previous manifest valid).

        This is the ``checkpoint_write`` resilience seam: transient I/O
        failures (including injected partial writes — which die before
        the rename, so the previous manifest state stays valid) are
        retried; the whole unit write is idempotent, so a retry simply
        rewrites every array and the manifest."""
        from .. import resilience

        def write() -> None:
            names = {}
            for name, arr in arrays.items():
                fname = f"{_safe(key)}.{name}.npy"
                _atomic_save(self.dir / fname, arr)
                names[name] = fname
            self._done[key] = names
            _atomic_write_text(
                self._manifest_path,
                json.dumps(self._done, indent=0, sort_keys=True),
            )

        resilience.resilient_call("checkpoint_write", write)

    def load_unit(self, key: str) -> dict[str, np.ndarray]:
        names = self._done[key]
        return {name: np.load(self.dir / fname) for name, fname in names.items()}

    def drop_unit(self, key: str) -> None:
        """Forget a unit: remove it from the manifest first (so a crash
        mid-drop leaves at worst orphaned .npy files, never a manifest
        entry pointing at deleted data), then best-effort unlink."""
        names = self._done.pop(key, None)
        if names is None:
            return
        _atomic_write_text(
            self._manifest_path, json.dumps(self._done, indent=0, sort_keys=True)
        )
        for fname in names.values():
            try:
                (self.dir / fname).unlink()
            except OSError:
                pass


def _safe(key: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in key)


def _atomic_save(path: pathlib.Path, arr: np.ndarray) -> None:
    from ..resilience import inject

    tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
    try:
        with open(tmp, "wb") as f:  # explicit handle: np.save won't append .npy
            np.save(f, arr)
            # Chaos hook: a pending 'partial' rule truncates the temp
            # file and raises HERE — before the rename — proving the
            # final path never sees a torn write.
            inject.corrupt_stream("checkpoint_write", f)
        os.replace(tmp, path)
    except BaseException:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise


def _atomic_write_text(path: pathlib.Path, text: str) -> None:
    tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
    try:
        tmp.write_text(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise
