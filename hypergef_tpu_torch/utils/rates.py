"""The NVIDIA H100 SXM's data-sheet rates (80 GB HBM3, 700 W).

The planner's card floor model (``sparse/planner.py::card_floor_rates``)
and the kernel bounds (``utils/profiling.py::bound``) read them: a model
from the data sheet, not a measurement.
"""

# HBM3's memory rate, bytes a second
H100_STREAM_BPS = 3.35e12
# the dense bf16 tensor-core rate, where the band kernel does its tile products
H100_BF16_TC_OPS_PER_S = 989e12
# the f32 rate outside the tensor cores, where every other kernel of the port
# does its arithmetic
H100_F32_OPS_PER_S = 67e12
