# Copy of arterynetwork_tpu/constants.py, unchanged.
"""Physical constants and unit conversions used across the framework.

The reference scatters conversion constants through the code (the factor
``13560 * 9.8`` appears ~100 times in ``fluidSimulation.py``, e.g. lines
565, 1341, 1708).  Here they are centralized once.

Unit discipline (same convention as the reference, fluidSimulation.py:67):
  * volumes are indexed in voxels; ``spacing`` (m/voxel) converts to meters
  * pressures are in Pascal internally, displayed in mmHg
  * flows are in m^3/s internally, displayed in cm^3/s
  * velocities are in m/s
"""

from __future__ import annotations

# Density of mercury (kg/m^3) times g (m/s^2): converts a mercury column
# height in meters to Pascal.  Reference: fluidSimulation.py:4640-4643.
RHO_MERCURY = 13560.0
GRAVITY = 9.8
RHO_BLOOD = 1050.0  # kg/m^3 (fluidSimulation.py:4640)
BLOOD_KINEMATIC_VISCOSITY = 2.6e-6  # m^2/s (fluidSimulation.py:4645)

# 1 mmHg in Pascal (= 13560 * 9.8 / 1000).
PASCAL_PER_MMHG = RHO_MERCURY * GRAVITY / 1000.0

# Default physical size of one voxel in meters (fluidSimulation.py:67).
DEFAULT_SPACING = 0.00040

# Inlet boundary conditions used by the reference's ground-truth generator
# (fluidSimulation.py:565-567).
INLET_PRESSURE = RHO_MERCURY * GRAVITY * 0.12      # Pa (~120 mmHg)
INLET_VELOCITY = 1.5                               # m/s
INLET_FLOW = 754.0 / 60.0 / 10.0 ** 6              # m^3/s (754 ml/min)

# Compartment inlet pressure for ADAN-based terminating-pressure models
# (fluidSimulation.py:1413-1415).
COMPARTMENT_INLET_PRESSURE = RHO_MERCURY * GRAVITY * 0.115  # Pa (~115 mmHg)

# Hazen-Williams constants.  The reference writes the pressure drop as
#   dP = 10.67 * Q**k * L / c**k / D**4.8704        (fluidSimulation.py:530)
HW_COEFF = 10.67
HW_DIAMETER_EXPONENT = 4.8704

# Error scaling used by the reference residual (fluidSimulation.py:4714-4717).
FLOW_ERROR_FACTOR = 10.0 ** 6 * 20000.0
PRESSURE_ERROR_FACTOR = 1000.0 / (RHO_MERCURY * GRAVITY) * 500.0
BOUNDARY_ERROR_FACTOR = 10.0

# Solver variable bounds used by the reference (fluidSimulation.py:1718).
MAX_VELOCITY = 5.0                                  # m/s
MAX_PRESSURE = RHO_MERCURY * GRAVITY * 0.12         # Pa (120 mmHg)


def mmhg_to_pascal(p_mmhg):
    return p_mmhg * PASCAL_PER_MMHG


def pascal_to_mmhg(p_pascal):
    return p_pascal / PASCAL_PER_MMHG
