"""Rewrite a serving export of the JAX package in the layout the PyTorch
package reads.

The JAX package writes exports with orbax, by default as OCDBT, whose
files are zstd-compressed: numpy alone cannot read them.  This tool
loads such an export (OCDBT or not) with the JAX package's
``checkpoint.load_for_serving`` and writes it again with the PyTorch
package's ``checkpoint.save_for_serving``, keeping ``metadata.json``
and the manifest's step::

    python convert_jax_export.py SRC DST

It runs where JAX and orbax are installed (the TPU host); the GPU host
then needs only the PyTorch package.  Every leaf is written with its
dtype and bits unchanged (bf16 stays bf16).  DST is published
atomically, as every export is.
"""

import argparse
import os
import sys


def convert(src, dst):
    """Load the export at ``src`` with the JAX package and write it to
    ``dst`` with the PyTorch package; returns ``dst``."""
    import jax
    import numpy as np

    from tensorflowonspark_tpu import checkpoint as jax_checkpoint
    from tensorflowonspark_tpu_torch import checkpoint

    params, meta = jax_checkpoint.load_for_serving(src)
    manifest = jax_checkpoint.read_manifest(src) or {}
    params = jax.tree.map(np.asarray, params)
    return checkpoint.save_for_serving(dst, params, extra_metadata=meta,
                                       step=manifest.get("step"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("src", help="the JAX package's serving export")
    parser.add_argument("dst", help="where to write the converted export")
    args = parser.parse_args(argv)
    if os.path.abspath(args.src) == os.path.abspath(args.dst):
        parser.error("SRC and DST must differ")
    print(convert(args.src, args.dst))
    return 0


if __name__ == "__main__":
    sys.exit(main())
