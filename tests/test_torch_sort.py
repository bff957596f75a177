"""Kernel K3's plain version (zikkurat_algebra_tpu_torch.ops.kernel_sort)
against the JAX package's Pallas sort, run in interpret mode.

The JAX sort is not stable, so the keys are compared in order and the
payload as a multiset of (key, payload...) columns for each window, as
tests/test_pallas_sort.py does.  The port's sort is stable: a case pins
that, and another the refusal of keys outside [0, 2^key_bits).
tests/test_torch_gpu.py holds the kernel itself against the plain
version on the card.
"""

import jax
import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu.ops.pallas_sort import sort_key_val_pallas
from zikkurat_algebra_tpu_torch.ops import kernel_sort

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)


@pytest.mark.parametrize(
    "wc,n,R,tile_log2",
    [(2, 1 << 11, 4, 9),    # multi-tile, 4 cross stages
     (1, 1 << 9, 27, 13),   # single tile (tile shrinks to n), MSM row count
     (3, 1 << 10, 2, 10)],  # tile == n boundary
)
def test_sort_plain_vs_jax(wc, n, R, tile_log2):
    g = np.random.default_rng(n + R)
    keys = g.integers(0, 1 << 14, (wc, n)).astype(np.int32)
    pay = g.integers(0, 1 << 30, (R, wc, n)).astype(np.int32)
    sk, sp = kernel_sort.sort_key_val(torch.from_numpy(keys),
                                      torch.from_numpy(pay), 14)
    jk, jp = jax.jit(lambda k, p: sort_key_val_pallas(
        k, p, tile_log2, interpret=True))(keys, pay)
    assert np.array_equal(sk.numpy(), np.asarray(jk))
    got = np.concatenate([sk.numpy()[None], sp.numpy()], 0)
    want = np.concatenate([np.asarray(jk)[None], np.asarray(jp)], 0)
    for w in range(wc):
        assert sorted(map(tuple, got[:, w].T)) == sorted(map(tuple,
                                                             want[:, w].T))


def test_sort_is_stable_and_checks_keys():
    """Equal keys keep their input order (the MSM's buckets then equal
    those of a stable torch.sort); n need not be a power of two."""
    g = np.random.default_rng(5)
    wc, n = 3, 1000
    keys = torch.from_numpy(g.integers(0, 4, (wc, n)).astype(np.int32))
    keys[2] = 3                                        # one all-equal row
    pos = torch.arange(n, dtype=torch.int32).expand(1, wc, n).contiguous()
    sk, (order,) = kernel_sort.sort_key_val(keys, pos, 2)
    for w in range(wc):
        k, o = keys[w].numpy(), order[w].numpy()
        assert np.array_equal(o, np.argsort(k, kind="stable"))
        assert np.array_equal(sk[w].numpy(), k[o])
    with pytest.raises(ValueError, match="outside"):
        kernel_sort.sort_key_val(keys, pos, 1)             # 2 and 3 >= 2^1
    with pytest.raises(ValueError, match="outside"):
        kernel_sort.sort_key_val(-keys - 1, pos, 8)        # negative keys
    with pytest.raises(ValueError):
        kernel_sort.sort_key_val(keys, pos[:, :2], 8)      # payload shape
    with pytest.raises(TypeError):
        kernel_sort.sort_key_val(keys.long(), pos, 8)
    with pytest.raises(ValueError):
        kernel_sort.sort_key_val(keys.to("meta"), pos.to("meta"), 8)
