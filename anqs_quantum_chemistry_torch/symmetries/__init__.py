from .symmetry import (
    Symmetry,
    particle_number_symmetry,
    spin_projection_symmetry,
    z2_symmetry,
    idle_symmetry,
)
from .masker import Masker
from .grouping import QubitGrouping

ALLOWED_SYMMETRY_LEVELS = ("no_sym", "e_num", "e_num_spin", "z2")
