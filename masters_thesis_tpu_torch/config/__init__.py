"""Config composition for the port's drivers (counterpart of
``masters_thesis_tpu/config``), on the port's own YAML subset reader."""

from masters_thesis_tpu_torch.config.compose import (
    Config,
    compose,
    expand_multirun,
    register_resolver,
    to_flat_dict,
)

__all__ = [
    "Config",
    "compose",
    "expand_multirun",
    "register_resolver",
    "to_flat_dict",
]
