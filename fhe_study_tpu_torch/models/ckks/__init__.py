"""CKKS: the host encoder, the device encoder and RNS-CKKS — the ported part
of fhe_study_tpu/models/ckks/."""

from .encoder import Encoder  # noqa: F401
