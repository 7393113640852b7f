from .params import RingParam, TORUS_Q
from . import tn

__all__ = ["RingParam", "TORUS_Q", "tn"]
