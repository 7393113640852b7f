from .glwe import (Param, GLWE, GLev, KSK, new_key, pk_from_sk, encrypt,
                   encrypt_s, decrypt, encode, decode, mod_switch, add, sub,
                   add_pt, mul_pt, new_ksk, key_switch)
from . import glev
