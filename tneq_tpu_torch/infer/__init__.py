from .probability import (
    full_probability,
    marginal_probability,
    conditional_probability,
)
from .sampling import sample

__all__ = [
    "full_probability",
    "marginal_probability",
    "conditional_probability",
    "sample",
]
