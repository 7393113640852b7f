"""CKKS: the host encoder, the device encoder, single-modulus CKKS
(``ckks``) and RNS-CKKS — the counterpart of fhe_study_tpu/models/ckks/."""

from .encoder import Encoder  # noqa: F401
from . import ckks  # noqa: F401
