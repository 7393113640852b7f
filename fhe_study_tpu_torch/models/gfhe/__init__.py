from .glwe import (Param, GLWE, new_key, pk_from_sk, encrypt, encrypt_s,
                   decrypt, add, sub, add_pt, mul_pt)
