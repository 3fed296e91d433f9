"""Host-side helpers (copies of the JAX package's ``utils/``, cut to
what the port uses) and the port's not-ported error."""


def not_ported(what, item):
    """The error a knob or entry point of the reference that the port
    does not have yet raises, naming its ROADMAP queue A item."""
    return NotImplementedError(
        "{0} is not ported to the PyTorch package yet (ROADMAP queue A: "
        "{1})".format(what, item)
    )
