"""Path normalization across local/remote filesystem schemes (copy of
the JAX package's ``utils/paths.py``; original: tensorflowonspark/
TFNode.py:29-64 ``hdfs_path``)."""

import getpass
import os

#: Schemes passed through untouched when already fully qualified.
_KNOWN_SCHEMES = (
    "hdfs://",
    "viewfs://",
    "file://",
    "gs://",
    "s3://",
    "s3a://",
    "s3n://",
    "abfs://",
    "abfss://",
    "wasb://",
    "maprfs://",
)


def resolve_path(path, default_fs="file://", working_dir=None):
    """Normalize ``path`` against ``default_fs``.

    - Fully-qualified paths (any known scheme) are returned as-is.
    - Absolute paths are joined to the default filesystem scheme.
    - Relative paths resolve against the working dir for ``file://`` or
      the user's home dir for remote filesystems.
    """
    if any(path.startswith(s) for s in _KNOWN_SCHEMES):
        return path
    if working_dir is None:
        working_dir = os.getcwd()
    if path.startswith("/"):
        if default_fs.startswith("file://"):
            return "file://" + path
        return _join_fs(default_fs, path)
    if default_fs.startswith("file://"):
        return "file://" + os.path.join(working_dir, path)
    user = getpass.getuser()
    return _join_fs(default_fs, "/user/{0}/{1}".format(user, path))


def _join_fs(default_fs, abs_path):
    base = default_fs[:-1] if default_fs.endswith("/") else default_fs
    return base + abs_path
