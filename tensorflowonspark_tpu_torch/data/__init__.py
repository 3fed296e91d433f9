"""The compute-process side of the feed plane (port of the JAX
package's ``data/``)."""
