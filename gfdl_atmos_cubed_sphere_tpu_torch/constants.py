"""Physical constants for the FV3 core (PyTorch port; same values as the JAX package).

Mirrors the subset of FMS ``constants_mod`` actually consumed by the reference
(see SURVEY.md Appendix A; reference imports at e.g.
FV3 model/fv_dynamics.F90:23-54).

``radius`` and ``omega`` are *mutable at configuration time* in the reference
(small-earth scaling, fv_arrays.F90:40-41); here they are module defaults that
idealized test cases may override through ``GridConfig``.
"""

import numpy as np

# Earth geometry
RADIUS = 6.3712e6            # mean Earth radius [m]
OMEGA = 7.292e-5             # Earth rotation rate [1/s]
PI = float(np.pi)

# Thermodynamics (GFDL constants_mod values)
GRAV = 9.80665               # gravity [m/s^2]
RDGAS = 287.04               # gas constant dry air [J/kg/K]
RVGAS = 461.50               # gas constant water vapor [J/kg/K]
CP_AIR = 1004.6              # dry air heat capacity, const p [J/kg/K]
CV_AIR = CP_AIR - RDGAS      # dry air heat capacity, const v
CP_VAPOR = 4.0 * RVGAS       # vapor heat capacity, const p
CV_VAP = 3.0 * RVGAS         # vapor heat capacity, const v
KAPPA = RDGAS / CP_AIR
HLV = 2.5e6                  # latent heat of evaporation [J/kg]
HLF = 3.3358e5               # latent heat of fusion [J/kg]
TFREEZE = 273.15             # freezing point [K]
PSTD_MKS = 101325.0          # standard surface pressure [Pa]
SECONDS_PER_DAY = 86400.0
RAD_TO_DEG = 180.0 / PI
DEG_TO_RAD = PI / 180.0

# Water molecular weights (for MULTI_GASES-style conversions)
WTMAIR = 2.896440e1
WTMH2O = 1.801534e1

ZVIR = RVGAS / RDGAS - 1.0   # virtual temperature factor

# Condensate heat capacities (gfdl_mp constants; c_liq/c_ice)
C_LIQ = 4.1855e3             # heat capacity of liquid water [J/kg/K]
C_ICE = 1.972e3              # heat capacity of ice [J/kg/K]
TICE = 273.16                # freezing of fresh water [K] (gfdl_mp t_ice)
EPS = RDGAS / RVGAS          # molecular-weight ratio
EPSM1 = EPS - 1.0
