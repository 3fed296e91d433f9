"""Fault injection for the port's fault-tolerance tests (a copy of the
JAX package's ``testing/``, cut to what the port uses)."""
