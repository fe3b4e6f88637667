"""File formats (copy of the pyratbay_tpu.io subset the slice uses)."""
from .io import (
    read_atm,
    write_atm,
    read_cs,
    write_cs,
    read_opacity,
    write_opacity,
    read_spectrum,
    write_spectrum,
    read_molecs,
    read_observations,
    write_observations,
    read_pf,
    write_pf,
    save_model,
    load_model,
)
