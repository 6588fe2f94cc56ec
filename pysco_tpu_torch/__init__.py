"""pysco-tpu-torch: the PyTorch/CUDA port of ``pysco_tpu`` for one NVIDIA
Hopper GPU (H100).

It reads the same param.ini/dict keys and writes the same files as the
JAX package (ASCII power spectra, HDF5/Parquet snapshots, the background
evolution table). It runs the Newtonian, parametrized, f(R) and QUMOND
theories with the FFT and multigrid Poisson solvers on one device, with
LPT initial conditions built on the device; every kernel of the JAX
package's Pallas set is a CUDA C++ kernel written for ``sm_90a``
(``csrc/``), built by ``nvcc`` at first use.

No global dtype switch: host scalars stay Python floats, and every
device grid and particle array is float32. The package never imports
JAX.
"""

from .main import run, run_paired  # noqa: F401
from .utils.config import read_param_file  # noqa: F401

__version__ = "0.1.0"
