"""The FLOPs the window's answered queries need (centroid scores, the
probed cells' products, MaxSim at valid tokens; counted from shapes, the
reference's probe ranking and the answers' docs) over the traced window at
the fp16 tensor-core peak of 989 TFLOP/s, in %."""
from espnbench.readers import mfu


def read(record):
    return mfu(record)
