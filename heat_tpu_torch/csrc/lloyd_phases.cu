// The Lloyd step of lloyd.cu with its per-phase clock64() stamps compiled in:
// a measurement build, loaded by heat_tpu_torch/core/kernels.py::lloyd_phase_cycles
// and run by chip_smoke.py's lloyd_phases phase.  Nothing on the main path
// calls it.  The build hashes lloyd.cu with this file (core/_build.py).
#define HEAT_LLOYD_PHASES
#include "lloyd.cu"
