"""The input generators are functions of the seed: the same seed gives the
same inputs, another seed others, and every value is canonical."""

import pytest

from conftest import make_small_root
from zkbench import bls, harness, inputs


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3, -12])
def test_sub_seeds_are_stable(seed):
    assert inputs.sub_seed(seed, 1, 2) == inputs.sub_seed(seed, 1, 2)
    assert inputs.sub_seed(seed, 1, 2) != inputs.sub_seed(seed, 1, 3)
    assert 0 <= inputs.sub_seed(seed, 1, 2) < 1 << 63


@pytest.mark.parametrize("mod", [bls.R, bls.P, 97, (1 << 64) - 59])
def test_uniform_limbs_canonical_and_repeatable(mod):
    a = inputs.uniform_limbs(inputs.torch_gen(3, "cpu", 9), mod, 500, "cpu")
    b = inputs.uniform_limbs(inputs.torch_gen(3, "cpu", 9), mod, 500, "cpu")
    c = inputs.uniform_limbs(inputs.torch_gen(4, "cpu", 9), mod, 500, "cpu")
    assert a.equal(b) and not a.equal(c)
    vals = inputs.limbs_to_ints(a)
    assert all(0 <= v < mod for v in vals)
    assert inputs.ints_to_limbs(vals, a.shape[0]).tolist() == a.tolist()


def test_column_sums():
    vals = list(range(1, 13))
    limbs = inputs.ints_to_limbs([v << 200 for v in vals], 8)
    sums = inputs.column_sums(limbs, 4)
    assert sums == [sum(vals[i::4]) << 200 for i in range(4)]


@pytest.mark.parametrize("cell", ["prover2p20-g1msm", "prover2p20-polymul"])
def test_operation_inputs_follow_the_seed(tmp_path, cell):
    import torch

    root = make_small_root(tmp_path)
    c = harness.load_cell(root, cell)

    def draw(seed):
        d = harness.load_operation(root, c.mix["op"]).Operation(
            root=root, config=c.config, mix=c.mix, seed=seed,
            device=torch.device("cpu"))
        d.setup()
        out = [d.inputs(i) for i in (0, 1, 5)]
        return [tuple(x.tolist() if hasattr(x, "tolist") else x
                      for x in (o if isinstance(o, tuple) else (o,)))
                for o in out]

    assert draw(11) == draw(11)
    assert draw(11) != draw(12)
