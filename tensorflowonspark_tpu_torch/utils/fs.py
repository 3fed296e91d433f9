"""Filesystem helpers: a local fast path, and ``fsspec`` for remote URIs
(a copy of the JAX package's ``utils/fs.py``).

Any ``scheme://`` URI (gs, s3, hdfs, memory, ...) goes through
``fsspec`` when it is installed; plain paths and ``file://`` URIs use
the standard library (and keep the native codec of
:mod:`..data.tfrecord`).  ``fsspec`` is optional: importing this module
never imports it, and a remote path without it raises ``ImportError``.
"""

import os
import posixpath

_LOCAL_SCHEMES = ("", "file")


def split_scheme(path):
    """``"gs://b/k"`` -> ``("gs", "b/k")``; plain paths -> ``("", path)``.
    Windows drive letters are not schemes."""
    path = os.fspath(path)
    idx = path.find("://")
    if idx <= 1:  # no scheme, or a drive letter
        return "", path
    return path[:idx], path[idx + 3:]


def is_remote(path):
    return split_scheme(path)[0] not in _LOCAL_SCHEMES


def local_path(path):
    """Strip a ``file://`` prefix; other schemes raise ``ValueError``."""
    scheme, rest = split_scheme(path)
    if scheme == "":
        return path
    if scheme == "file":
        return "/" + rest.lstrip("/") if not rest.startswith("/") else rest
    raise ValueError("not a local path: {0}".format(path))


def _fs_for(path):
    try:
        import fsspec
    except ImportError:
        raise ImportError(
            "fsspec is required for remote paths ({0}); install it or "
            "use a local path".format(path)
        )
    return fsspec.core.url_to_fs(path)


def open_file(path, mode="rb"):
    """Open local or remote ``path``; returns a file-like object."""
    if not is_remote(path):
        return open(local_path(path), mode)
    fs, fs_path = _fs_for(path)
    return fs.open(fs_path, mode)


def makedirs(path):
    if not is_remote(path):
        os.makedirs(local_path(path), exist_ok=True)
        return
    fs, fs_path = _fs_for(path)
    fs.makedirs(fs_path, exist_ok=True)


def exists(path):
    if not is_remote(path):
        return os.path.exists(local_path(path))
    fs, fs_path = _fs_for(path)
    return fs.exists(fs_path)


def isdir(path):
    if not is_remote(path):
        return os.path.isdir(local_path(path))
    fs, fs_path = _fs_for(path)
    return fs.isdir(fs_path)


def join(path, *parts):
    """Join path components, URI-aware (posix separators for remote)."""
    if not is_remote(path):
        return os.path.join(path, *parts)
    return posixpath.join(path, *parts)


def list_files(path):
    """The files directly under ``path`` as full paths (remote results
    keep their scheme), sorted, dotfiles included (callers filter)."""
    if not is_remote(path):
        return sorted(e.path for e in os.scandir(local_path(path))
                      if e.is_file())
    scheme, _ = split_scheme(path)
    fs, fs_path = _fs_for(path)
    out = []
    for info in fs.ls(fs_path, detail=True):
        if info.get("type") == "file":
            name = info["name"]
            out.append(
                name if "://" in name else "{0}://{1}".format(scheme, name)
            )
    return sorted(out)


def basename(path):
    scheme, rest = split_scheme(path)
    return (posixpath.basename(rest.rstrip("/")) if scheme
            else os.path.basename(path))
