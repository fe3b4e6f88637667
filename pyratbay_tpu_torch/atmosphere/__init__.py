"""Atmospheric structure: pressure/temperature profiles, free VMR
models, hydrostatic radii and transit geometry, as functions of
tensors whose leading dimension is the chain ensemble."""
from .profiles import (
    pressure,
    isothermal_tp,
    guillot_tp,
    madhu_tp,
    get_tmodel,
)
from .vmr import (
    uniform_vmr,
    iso_vmr,
    scale_vmr,
    slant_vmr,
    bulk_ratio,
    balance_bulk,
    vmr_scale,
    qcapcheck,
)
from .hydro import (
    hydro_g,
    hydro_m,
    hill_radius,
    mean_weight,
    ideal_gas_density,
    equilibrium_temp,
)
from .geometry import (
    transit_path_matrix,
)
from .chem import (
    Network,
    chemistry,
)
