"""Parse/mtime cache: a warm run parses only the files that changed.

The analyzer's cost is dominated by reading + ``ast.parse``-ing every
file; the interprocedural passes re-walk the same trees. This cache
pickles parsed trees keyed by ``(mtime_ns, size)`` so a warm run skips
parsing for every unchanged file — the common CI/pre-commit case where
one file changed and 200 didn't.

Correctness over cleverness:

- the key is per-file ``(mtime_ns, size)``; any mismatch re-parses
  (there is no content hash: stat is the budget here);
- the cache format carries a version stamp (bump ``_VERSION`` when the
  :class:`~.core.Module` shape changes) and the Python version (pickled
  AST objects are not stable across interpreter versions);
- every failure mode — unreadable cache, unpicklable entry, version
  skew — silently degrades to a full parse. The cache can make lint
  faster, never wrong.

The cache file lives in ``<repo>/.lint_cache/`` (gitignored): the
analyzer must not write inside the package tree it is analyzing. It is
the port's own file: the JAX package's analyzer keeps ``parse.pkl``
beside it, and the two never read each other's trees.

The cache's contract is asserted by count, not by wall clock: pass a
``stats`` dict and it comes back with ``parsed`` (files read and parsed
this call) and ``reused`` (files taken from the cache).
"""

from __future__ import annotations

import ast
import pathlib
import pickle
import sys

from .core import Module, default_roots, repo_root, root_files

# The port's own stamp: a cache the JAX analyzer wrote never matches it.
_VERSION = "torch-1"
CACHE_REL = ".lint_cache/parse_torch.pkl"


def _cache_key() -> tuple:
    return (_VERSION, sys.version_info[:2])


def load_modules_cached(
    roots: dict | None = None,
    repo: pathlib.Path | None = None,
    cache_path: pathlib.Path | str | None = None,
    stats: dict | None = None,
) -> list[Module]:
    """Drop-in for :func:`~.core.load_modules` with the pickle cache.
    Walk order and Module contents are identical to the uncached
    loader — byte-stable output is part of the contract."""
    repo = repo or repo_root()
    roots = roots or default_roots(repo)
    cache_file = (
        pathlib.Path(cache_path) if cache_path is not None
        else repo / CACHE_REL
    )
    entries: dict[str, tuple] = {}
    try:
        with open(cache_file, "rb") as f:
            stored = pickle.load(f)
        if stored.get("key") == _cache_key():
            entries = stored.get("files", {})
    except Exception:
        entries = {}

    modules: list[Module] = []
    fresh: dict[str, tuple] = {}
    dirty = False
    parsed = reused = 0
    for kind in sorted(roots):
        base, paths = root_files(roots[kind])
        for path in paths:
            try:
                st = path.stat()
                stat_key = (st.st_mtime_ns, st.st_size)
            except OSError:
                continue
            try:
                repo_rel = (
                    path.resolve().relative_to(repo.resolve()).as_posix()
                )
            except ValueError:
                repo_rel = path.as_posix()
            cached = entries.get(repo_rel)
            if cached is not None and cached[0] == stat_key:
                text, tree = cached[1], cached[2]
                reused += 1
            else:
                dirty = True
                try:
                    text = path.read_text(encoding="utf-8")
                    tree = ast.parse(text, filename=str(path))
                except (OSError, SyntaxError):
                    continue
                parsed += 1
            fresh[repo_rel] = (stat_key, text, tree)
            modules.append(Module(
                path=path,
                rel=path.relative_to(base).as_posix(),
                repo_rel=repo_rel,
                root_kind=kind,
                text=text,
                tree=tree,
            ))
    if dirty or set(fresh) != set(entries):
        try:
            cache_file.parent.mkdir(parents=True, exist_ok=True)
            tmp = cache_file.with_suffix(".tmp")
            with open(tmp, "wb") as f:
                pickle.dump(
                    {"key": _cache_key(), "files": fresh}, f,
                    protocol=pickle.HIGHEST_PROTOCOL,
                )
            tmp.replace(cache_file)
        except Exception:
            pass  # a cache that can't be written is just a cold cache
    if stats is not None:
        stats.update(parsed=parsed, reused=reused)
    return modules
