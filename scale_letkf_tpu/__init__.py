"""Ensemble data-assimilation framework in JAX (SCALE-LETKF capabilities).

A from-scratch JAX/XLA/Pallas re-design of the SCALE-LETKF regional NWP
data-assimilation system (reference: gylien/scale-letkf, Fortran/MPI):

- ``model``     — regional compressible nonhydrostatic finite-volume core
- ``ops``       — batched LETKF transform, localization, obs selection kernels
- ``obs``       — observation taxonomy, operators H(x), QC, file I/O
- ``da``        — analysis driver (das_letkf equivalent), obsope, monitors
- ``parallel``  — device mesh, halo exchange, ensemble transpose
- ``io``        — restart checkpointing
- ``cycle``     — the DA cycle driver (replaces scale/run/cycle.sh)
"""

__version__ = "0.1.0"

from scale_letkf_tpu.config import Config  # noqa: F401
