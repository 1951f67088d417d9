"""Idealized tracer initializations, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/init/tracers.py: checker_tracer
is FV3 tools/test_cases.F90 checker_tracers:3794 (the HIWPP checkerboard),
q = 1 where sin(nx*lon)*sin(ny*lat) >= 0, else 0, uniform in the
vertical. Host numpy, like the rest of init/.
"""

import numpy as np


def checker_tracer(geom, npz, nx=9.0, ny=9.0):
    """[6, npz, n, n] checkerboard mixing ratio on A-grid cell centers."""
    lon = geom.interior("aglon")
    lat = geom.interior("aglat")
    qt = np.where(np.sin(nx * lon) * np.sin(ny * lat) < 0.0, 0.0, 1.0)
    return np.broadcast_to(qt[:, None], (6, npz) + qt.shape[1:]).copy()
