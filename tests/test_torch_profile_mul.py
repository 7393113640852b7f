"""utils/profile_mul.py's stages: on the CPU (the plain versions) each
multiply's stages, fed the inputs the real multiply hands them, put back
together equal the multiply bit for bit, for mul_e and mul with either
relin key (the timing itself needs the card)."""

import pytest
import torch

from fhe_study_tpu_torch.models import bfv_rns as R
from fhe_study_tpu_torch.utils import prng, profile_mul

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    param = R.RnsParam(n=256, t=256, L=4, M=5)
    gen = prng.Gen(5)
    sk, pk = R.new_key(gen, param, CPU)
    keys = {"RLK": R.rlk_key(gen, param, sk),
            "HRLK": R.hybrid_rlk1(gen, param, sk)}
    m = [prng.uniform_mod(gen, (2, 256), 256, CPU) for _ in range(2)]
    c = [R.encrypt(gen, param, pk, x, batch=(2,)) for x in m]
    return param, keys, c, [R.to_evals(param, x) for x in c]


@pytest.mark.parametrize("mode", ["eval", "coeff"])
@pytest.mark.parametrize("kname", ["RLK", "HRLK"])
def test_stages_compose_to_the_multiply(setup, mode, kname):
    param, keys, c, e = setup
    x, y = e if mode == "eval" else c
    named, compose = profile_mul.stages(param, keys[kname], x, y, mode)
    names = [nm for nm, _ in named]
    assert names[:5] == ["A tensor Q", "B tensor P", "C ext wQ->P +sub",
                         "D ext rP->Q centered", "E relin"]
    assert names[-1] == "G whole multiply"
    want = named[-1][1]()
    got = compose()
    assert type(got) is type(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_profile_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for the CPU")
    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_mul.main(["eval", "--n", "256"])
