from . import tlwe, tlev, tgsw, tglwe, tggsw, bootstrap
