"""The phase probe of the split instances at n = 2^15
(fhe_study_tpu_torch/utils/ks_phases.py): its marks find the kernels'
headers of this checkout, each mark once, and put a counter at every phase
it reads out.  The probe itself needs a card and nvcc."""

import re

import pytest

from fhe_study_tpu_torch.ops import _cuda
from fhe_study_tpu_torch.utils import ks_phases


@pytest.mark.parametrize("probe", (ks_phases.KS, ks_phases.K6),
                         ids=("k7_k8", "k6"))
def test_marks_find_the_header_and_count_every_phase(probe):
    src = (_cuda.CSRC / probe.header).read_text()
    schedule, text = ks_phases.instrumented(probe, src)
    assert schedule == "split_words"
    assert text.count("long long phase_t = clock64();") == 1
    assert text.count("__device__ unsigned long long g_phase[") == 1
    slots = len(probe.phases)
    assert f"g_phase[{ks_phases.BLOCKS} * {slots}]" in text
    hit = set()
    for expr in re.findall(r"FHE_PHASE\(([^)]*)\)\n", text):
        if "?" in expr:                       # digit ? a : b (K7 and K8)
            hit |= {int(v) for v in expr.split("?")[1].split(":")}
        else:                                 # of operand k (K6)
            hit |= {eval(expr, {"k": k}) for k in range(4)}
    assert hit == set(range(slots))


def test_marks_refuse_a_header_they_do_not_know():
    with pytest.raises(ValueError, match="update its marks"):
        ks_phases.instrumented(ks_phases.K6, "__global__ void k() {}\n")
