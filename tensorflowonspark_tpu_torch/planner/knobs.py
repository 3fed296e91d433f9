"""The serving knob names and the unknown-key check (the port's own copy
of ``validate_keys`` from the JAX package's ``planner/knobs.py``).

``serving_builder`` accepts these keys plus the ``TransformerConfig``
field names; anything else raises :class:`UnknownKnobError` naming the
near-misses, so a typo (``kv_page_token``) never silently serves with a
default.  Accepting a name here does not mean its plane is ported:
``serving_builder`` raises ``NotImplementedError`` for those.
"""

import difflib

#: the keys ``serving_builder`` accepts beyond TransformerConfig fields,
#: the same set as the JAX package's registry
SERVING_KEYS = frozenset((
    "mode", "auto", "max_new_tokens", "temperature", "top_k", "top_p",
    "seed", "speculative", "ngram", "pad_id", "eos_id", "input_name",
    "draft_config", "draft_params", "profile_dir", "profile_steps",
    "check_tiles", "mesh_shape", "weights", "quantize", "int4_group",
    "draft_len", "pad_multiple", "max_prompt_len", "chunk_size",
    "prefix_cache", "prefix_block", "prefix_mem_mb", "kv_layout",
    "kv_pages", "kv_page_tokens", "paged_impl", "tp", "disaggregate",
))


class UnknownKnobError(ValueError):
    """An unknown config key reached a builder.  Carries the offending
    keys, per-key suggestions, and the valid table."""

    def __init__(self, unknown, valid, where):
        self.unknown = tuple(sorted(unknown))
        self.valid = tuple(sorted(valid))
        self.where = where
        parts = []
        for key in self.unknown:
            close = difflib.get_close_matches(key, self.valid, n=2)
            parts.append("{0!r}{1}".format(
                key,
                " (did you mean {0}?)".format(
                    " or ".join(repr(c) for c in close)
                ) if close else "",
            ))
        super().__init__(
            "unknown config key(s) for {0}: {1}.  Valid keys: {2}".format(
                where, ", ".join(parts), ", ".join(self.valid)
            )
        )


def validate_keys(config, extra_valid=(), where="serving_builder"):
    """Raise :class:`UnknownKnobError` when ``config`` holds keys that
    are neither serving knobs nor ``extra_valid``."""
    valid = SERVING_KEYS | frozenset(extra_valid)
    unknown = [k for k in config if k not in valid]
    if unknown:
        raise UnknownKnobError(unknown, valid, where)
