"""The data plane (port of the JAX package's ``data/``): the compute
process's feed, the shared-memory ring and its native loader, the
columnar Example and TFRecord codecs, and on-device preprocessing.
Only :mod:`.preprocess` and the placement of :mod:`.feed` use ``torch``,
imported inside their functions."""
