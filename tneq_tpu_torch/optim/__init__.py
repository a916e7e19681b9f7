from .stiefel import sgdg, adamg, qr_retraction, matrix_norm_one
from .factory import make_optimizer
from .schedules import step_table_schedule

__all__ = [
    "sgdg",
    "adamg",
    "qr_retraction",
    "matrix_norm_one",
    "make_optimizer",
    "step_table_schedule",
]
